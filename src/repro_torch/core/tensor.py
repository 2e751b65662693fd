"""Tensor column API (§3.2): typed, append-only + in-place-editable, ragged.

A Tensor owns:
  * a :class:`ChunkEncoder` (index map) snapshot for the current version,
  * an open in-memory :class:`ChunkBuilder` absorbing appends,
  * per-sample ids (u64) for merge identity,
  * meta (htype, dtype, codec, chunk-size bounds, min/max shapes).

Chunking policy (§3.4): appends accumulate in the open chunk until its
*serialized* size would exceed ``max_chunk_size``; a chunk smaller than
``min_chunk_size`` left behind by an earlier version is reopened copy-on-write.
Samples whose encoded payload alone exceeds ``max_chunk_size`` are tiled
(:mod:`.tiling`).  All mutation is routed through the version-control layer so
time travel stays correct.
"""

from __future__ import annotations

import json
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import chunks as chunklib
from . import fetch
from .chunk_encoder import ChunkEncoder, ChunkStatsTable
from .chunks import FLAG_TILED, ChunkBuilder, ChunkHeader, ChunkStats
from .codecs import get_codec
from .htypes import get_htype
from .storage import StorageError, coalesce_ranges
from .tiling import (TileDescriptor, assemble_from_tiles, assemble_region,
                     plan_tile_shape, split_into_tiles, tiles_for_region)
from .version_control import VersionControl

DEFAULT_MIN_CHUNK = 8 << 20
DEFAULT_MAX_CHUNK = 16 << 20

#: speculative header read size: one ranged request covers the full header
#: of any chunk up to ~150 samples (48 + ~26 B/sample); larger headers pay
#: exactly one follow-up request for the remainder
HEADER_PROBE_BYTES = 4096


def _new_chunk_name(prefix: str = "c") -> str:
    return f"{prefix}{uuid.uuid4().hex[:12]}"


@dataclass
class TensorMeta:
    htype: str = "generic"
    dtype: Optional[str] = None
    codec: str = "raw"
    min_chunk_size: int = DEFAULT_MIN_CHUNK
    max_chunk_size: int = DEFAULT_MAX_CHUNK
    strict: bool = True
    min_shape: Optional[List[int]] = None
    max_shape: Optional[List[int]] = None
    links: List[str] = field(default_factory=list)  # storage providers for link[...]

    def to_json(self) -> dict:
        return self.__dict__.copy()

    @classmethod
    def from_json(cls, d: dict) -> "TensorMeta":
        m = cls()
        for k, v in d.items():
            setattr(m, k, v)
        return m

    def update_shape_bounds(self, shape: Tuple[int, ...]) -> None:
        s = list(shape)
        if self.min_shape is None:
            self.min_shape, self.max_shape = list(s), list(s)
            return
        if len(s) != len(self.min_shape):
            # ragged ndim: collapse to unconstrained
            n = max(len(s), len(self.min_shape))
            self.min_shape = [0] * n
            self.max_shape = [max(max(self.max_shape, default=0),
                                  max(s, default=0))] * n
            return
        self.min_shape = [min(a, b) for a, b in zip(self.min_shape, s)]
        self.max_shape = [max(a, b) for a, b in zip(self.max_shape, s)]


class Tensor:
    """One column of a dataset, bound to a version-control node."""

    def __init__(self, name: str, vc: VersionControl, meta: Optional[TensorMeta] = None,
                 node_id: Optional[str] = None) -> None:
        self.name = name
        self.vc = vc
        self.node_id = node_id          # None => follow vc.current (writable)
        self._header_cache: dict = {}
        self._fetch_engine: Optional["fetch.FetchEngine"] = None
        self._builder: Optional[ChunkBuilder] = None
        self._open_name: Optional[str] = None
        self._dirty = False
        # True while the open builder holds bytes newer than its last
        # upload — flush/commit retries skip re-putting an unchanged chunk
        self._builder_dirty = False
        if meta is not None:
            self.meta = meta
            self.encoder = ChunkEncoder()
            self.stats = ChunkStatsTable()
            self.sample_ids: List[int] = []
            self._dirty = True
        else:
            self._load_state()

    # ------------------------------------------------------------ state I/O
    def _load_state(self) -> None:
        """Load per-tensor state via the version-control state layer:
        manifest-covered nodes resolve every file from the consolidated
        snapshot (zero storage requests on a cold open)."""
        raw = self.vc.get_state(self.name, "meta.json", self.node_id)
        if raw is None:
            raise StorageError(f"tensor {self.name!r} has no state at this version")
        self.meta = TensorMeta.from_json(json.loads(raw.decode()))
        enc = self.vc.get_state(self.name, "chunk_encoder", self.node_id)
        self.encoder = ChunkEncoder.deserialize(enc) if enc else ChunkEncoder()
        st = self.vc.get_state(self.name, "chunk_stats.json", self.node_id)
        self.stats = ChunkStatsTable.deserialize(st) if st else ChunkStatsTable()
        ids = self.vc.get_state(self.name, "sample_ids", self.node_id)
        self.sample_ids = (
            [int(x) for x in np.frombuffer(zlib.decompress(ids), dtype="<u8")]
            if ids else [])

    def flush(self) -> None:
        """Persist open chunk + encoder + stats + ids + meta + chunk_set + diff."""
        if self.node_id is not None:
            return  # read-only binding
        if self._builder is not None and self._builder.num_samples \
                and self._builder_dirty:
            self.vc.register_new_chunk(self.name, self._open_name)
            key = self.vc.put_chunk(self.name, self._open_name,
                                    self._builder.serialize())
            self._builder_dirty = False
            self._discard_cached(key)  # the key's bytes just changed
            self.stats.set(self._open_name, self._builder.stats_snapshot())
        if not self._dirty:
            return
        self.stats.prune_to(self.encoder.chunk_names())
        self.vc.put_state(self.name, "chunk_stats.json", self.stats.serialize())
        self.vc.put_state(self.name, "chunk_encoder", self.encoder.serialize())
        self.vc.put_state(
            self.name, "sample_ids",
            zlib.compress(np.asarray(self.sample_ids, dtype="<u8").tobytes(), 1))
        self.vc.put_state(self.name, "meta.json",
                          json.dumps(self.meta.to_json()).encode())
        self.vc.flush_chunk_set(self.name)
        self.vc.flush_diff(self.name)
        self._dirty = False

    # --------------------------------------------------------------- basics
    def __len__(self) -> int:
        return self.encoder.num_samples

    @property
    def num_chunks(self) -> int:
        return self.encoder.num_chunks

    @property
    def dtype(self) -> Optional[np.dtype]:
        return np.dtype(self.meta.dtype) if self.meta.dtype else None

    @property
    def htype(self) -> str:
        return self.meta.htype

    @property
    def shape(self) -> Tuple[Optional[int], ...]:
        """(len, *dims) with None for ragged dims."""
        if self.meta.min_shape is None:
            return (len(self),)
        dims = tuple(a if a == b else None
                     for a, b in zip(self.meta.min_shape, self.meta.max_shape))
        return (len(self),) + dims

    @property
    def is_link(self) -> bool:
        return self.meta.htype.startswith("link[")

    @property
    def is_sequence(self) -> bool:
        return self.meta.htype.startswith("sequence[")

    # -------------------------------------------------------------- writing
    def _coerce(self, sample: Any) -> np.ndarray:
        if self.is_link and isinstance(sample, str):
            sample = np.frombuffer(sample.encode(), dtype=np.uint8).copy()
        arr = np.asarray(sample)
        if self.meta.dtype is None:
            # first sample locks the dtype (schema inference)
            spec = get_htype(self.meta.htype)
            self.meta.dtype = spec.default_dtype or arr.dtype.str
            self._dirty = True
        want = np.dtype(self.meta.dtype)
        if arr.dtype != want:
            if self.meta.strict and arr.dtype.kind != want.kind and arr.size:
                # allow int->float style promotion only when not strict
                if not np.can_cast(arr.dtype, want, casting="same_kind"):
                    raise TypeError(
                        f"tensor {self.name!r} ({want}) got {arr.dtype} sample")
            arr = arr.astype(want)
        if self.meta.strict:
            get_htype(self.meta.htype).validate(arr, self.meta.dtype)
        return arr

    def _fresh_builder(self) -> ChunkBuilder:
        return ChunkBuilder(self.meta.dtype, self.meta.codec)

    def _ensure_open(self, incoming_bytes: int) -> ChunkBuilder:
        """Return a builder with room for ``incoming_bytes`` more payload."""
        if self._builder is not None:
            if (self._builder.num_samples
                    and self._builder.nbytes_serialized() + incoming_bytes
                    > self.meta.max_chunk_size):
                self._finalize_open()
            else:
                return self._builder
        if self._builder is None:
            # copy-on-write reopen of an undersized trailing chunk (§3.4)
            if (self.encoder.num_chunks
                    and incoming_bytes < self.meta.max_chunk_size):
                last_ord = self.encoder.num_chunks - 1
                last_name = self.encoder.name_of(last_ord)
                key = self.vc.resolve_chunk_key(self.name, last_name, self.node_id)
                size = self.vc.storage.num_bytes(key) if self.vc.storage.exists(key) else 0
                if 0 < size < self.meta.min_chunk_size \
                        and size + incoming_bytes <= self.meta.max_chunk_size:
                    raw = self._engine().fetch_full(key)  # retries transients
                    header = chunklib.parse_header(raw)
                    b = self._fresh_builder()
                    for i in range(header.num_samples):
                        s, e = header.byte_range(i)
                        b.append_raw(raw[s:e], header.shapes[i], int(header.flags[i]))
                    n = self.encoder.samples_in(last_ord)
                    self.encoder.pop_last()
                    self.stats.drop(last_name)
                    self._builder = b
                    self._builder_dirty = True
                    self._open_name = _new_chunk_name()
                    self.encoder.register_chunk(self._open_name, n)
                    # drop the superseded chunk if it was born in this version
                    if last_name in self.vc.chunk_set(self.vc.current_id, self.name):
                        self.vc.forget_chunk(self.name, last_name)
                        self.vc.storage.delete(key)
                    self._discard_cached(key)
                    return self._builder
            self._builder = self._fresh_builder()
            self._open_name = _new_chunk_name()
        return self._builder

    def _finalize_open(self) -> None:
        if self._builder is None or not self._builder.num_samples:
            self._builder, self._open_name = None, None
            return
        self.vc.register_new_chunk(self.name, self._open_name)
        key = self.vc.put_chunk(self.name, self._open_name,
                                self._builder.serialize())
        self._builder_dirty = False
        self._discard_cached(key)  # the key's bytes just changed
        self.stats.set(self._open_name, self._builder.stats_snapshot())
        self._builder, self._open_name = None, None

    def _append_encoded(self, payload: bytes, shape: Tuple[int, ...], flags: int,
                        sample_id: Optional[int],
                        source: Optional[np.ndarray] = None) -> int:
        b = self._ensure_open(len(payload))
        was_empty = b.num_samples == 0
        b.append_raw(payload, shape, flags, source=source)
        self._builder_dirty = True
        if was_empty and (self.encoder.num_chunks == 0
                          or self.encoder.name_of(self.encoder.num_chunks - 1)
                          != self._open_name):
            self.encoder.register_chunk(self._open_name, 1)
        else:
            self.encoder.extend_last(1)
        idx = self.encoder.num_samples - 1
        self.sample_ids.append(sample_id if sample_id is not None
                               else int(uuid.uuid4().int & ((1 << 64) - 1)))
        self.meta.update_shape_bounds(shape)
        self.vc.record_append(self.name, idx, 1)
        self._dirty = True
        return idx

    def append(self, sample: Any, sample_id: Optional[int] = None) -> int:
        """Append one sample; returns its global index."""
        if self.node_id is not None:
            raise PermissionError("tensor bound to a sealed version is read-only")
        self.vc.require_writable()
        arr = self._coerce(sample)
        codec = get_codec(self.meta.codec)
        payload = codec.encode(arr)
        if len(payload) > self.meta.max_chunk_size:
            desc, effective = self._write_tiled(arr)
            # exact stats for tiled samples: the builder observes the array
            # a reader would reassemble, so the planner never degrades the
            # whole chunk to 'verify' just because one sample was tiled
            return self._append_encoded(desc.to_bytes(), tuple(arr.shape),
                                        FLAG_TILED, sample_id,
                                        source=effective)
        return self._append_encoded(payload, tuple(arr.shape), 0, sample_id,
                                    source=arr)

    def extend(self, samples: Sequence[Any]) -> None:
        for s in samples:
            self.append(s)

    def _write_tiled(self, arr: np.ndarray
                     ) -> Tuple[TileDescriptor, np.ndarray]:
        """Split + store tiles; returns the descriptor and the *effective*
        array (what a reader reassembles: ``arr`` itself for lossless
        codecs, the decoded round-trip for lossy ones) so stats computed
        at flush bound exactly what queries will read."""
        tile_shape = plan_tile_shape(
            arr.shape, arr.dtype.itemsize,
            max(1, int(self.meta.max_chunk_size * 0.8)))
        grid, tiles = split_into_tiles(arr, tile_shape)
        codec = get_codec(self.meta.codec)
        names = []
        payloads = []
        for t in tiles:
            name = _new_chunk_name("t")
            self.vc.register_new_chunk(self.name, name)
            payload = codec.encode(t)
            self.vc.put_chunk(self.name, name, payload)
            names.append(name)
            payloads.append(payload)
        desc = TileDescriptor(tuple(arr.shape), tile_shape, grid, names,
                              self.meta.dtype, self.meta.codec)
        effective = arr if not codec.lossy \
            else assemble_from_tiles(desc, payloads)
        return desc, effective

    # ------------------------------------------------------------- updating
    def __setitem__(self, idx: int, sample: Any) -> None:
        if self.node_id is not None:
            raise PermissionError("tensor bound to a sealed version is read-only")
        self.vc.require_writable()
        n = len(self)
        if idx < 0:
            idx += n
        if idx >= n:
            if self.meta.strict:
                raise IndexError(
                    f"index {idx} out of bounds for strict tensor of length {n}; "
                    f"create with strict=False for sparse assignment (§3.5)")
            empty = np.zeros((0,), dtype=self.meta.dtype or np.asarray(sample).dtype)
            while len(self) < idx:
                self.append(empty)
            self.append(sample)
            return
        arr = self._coerce(sample)
        codec = get_codec(self.meta.codec)
        payload = codec.encode(arr)
        flags = 0
        if len(payload) > self.meta.max_chunk_size:
            desc, _effective = self._write_tiled(arr)
            payload, flags = desc.to_bytes(), FLAG_TILED
        chunk_name, local = self.encoder.lookup(idx)
        if self._builder is not None and chunk_name == self._open_name:
            self._builder.replace_payload(local, payload, tuple(arr.shape), flags)
            self._builder_dirty = True
        else:
            self._rewrite_chunk(idx, chunk_name, local, payload,
                                tuple(arr.shape), flags)
        self.meta.update_shape_bounds(tuple(arr.shape))
        self.vc.record_update(self.name, idx)
        self._dirty = True

    def _rewrite_chunk(self, idx: int, chunk_name: str, local: int,
                       payload: bytes, shape: Tuple[int, ...], flags: int) -> None:
        """Copy-on-write a sealed/persisted chunk with one sample replaced."""
        key = self.vc.resolve_chunk_key(self.name, chunk_name, self.node_id)
        raw = self._engine().fetch_full(key)  # retries transients
        header = chunklib.parse_header(raw)
        b = self._fresh_builder()
        for i in range(header.num_samples):
            if i == local:
                b.append_raw(payload, shape, flags)
            else:
                s, e = header.byte_range(i)
                b.append_raw(raw[s:e], header.shapes[i], int(header.flags[i]))
        new_name = _new_chunk_name()
        self.vc.register_new_chunk(self.name, new_name)
        self.vc.put_chunk(self.name, new_name, b.serialize())
        ord_ = self.encoder.chunk_ord_of(idx)
        self.encoder.replace(ord_, new_name)
        self.stats.set(new_name, b.stats_snapshot())
        self.stats.drop(chunk_name)
        if chunk_name in self.vc.chunk_set(self.vc.current_id, self.name):
            self.vc.forget_chunk(self.name, chunk_name)
            self.vc.storage.delete(key)
        self._discard_cached(key)

    # --------------------------------------------------------------- reading
    def _engine(self) -> "fetch.FetchEngine":
        """The storage's shared fetch engine, cached per tensor so the
        per-sample read path skips the global registry lookup."""
        eng = self._fetch_engine
        if eng is None:
            eng = self._fetch_engine = fetch.engine_for(self.vc.storage)
        return eng

    def _discard_cached(self, key: str) -> None:
        """Invalidate every read-side cache of a chunk key whose bytes
        changed or vanished (open-chunk reflush, copy-on-write delete):
        the parsed-header memo and the shared engine's resident blob."""
        self._header_cache.pop(key, None)
        self._engine().discard(key)

    def prefetch_chunks(self, chunk_ords: Sequence[int], *,
                        owner: object = None, on_fetched=None,
                        budget: Optional[int] = None,
                        queued_bytes: int = 0) -> int:
        """Queue whole-chunk prefetches on the fetch engine, in the given
        order, skipping the open chunk.  Queued bytes are bounded by
        ``budget`` (default: half the destination buffer — LRU tier or
        resident store) with chunk sizes estimated from the stats sidecar;
        returns the accumulated queued bytes so callers can thread one
        budget across several tensors.  ``owner``/``on_fetched`` pass
        through to :meth:`FetchEngine.prefetch`.
        """
        engine = self._engine()
        if budget is None:
            budget = (engine.cache_above or engine.resident_bytes) // 2
        for o in chunk_ords:
            cname = self.encoder.name_of(int(o))
            if self._builder is not None and cname == self._open_name:
                continue
            st = self.stats.get(cname)
            est = st.nbytes if st is not None and st.nbytes \
                else self.meta.max_chunk_size
            if queued_bytes and queued_bytes + est > budget:
                break  # the rest is fetched (coalesced) on demand
            queued_bytes += est
            engine.prefetch(self._chunk_key(cname), owner=owner,
                            on_fetched=on_fetched)
        return queued_bytes

    def _chunk_key(self, chunk_name: str) -> str:
        return self.vc.resolve_chunk_key(self.name, chunk_name, self.node_id)

    def _header_of(self, key: str, ranged: bool,
                   counters: Optional[Dict[str, int]] = None) -> ChunkHeader:
        h = self._header_cache.get(key)
        if h is not None:
            return h
        engine = self._engine()
        blob = engine.resident(key)
        if blob is not None:
            h = chunklib.parse_header(blob)
        elif ranged:
            # speculative probe via the engine (observed by its stats and
            # cost EWMA): the whole header in one ranged request for
            # typical chunks, two for very wide ones (was always two)
            prefix = engine.fetch_ranges(key, [(0, HEADER_PROBE_BYTES)],
                                         counters=counters)[0]
            hs = chunklib.header_size_of(prefix)
            if hs > len(prefix):
                prefix += engine.fetch_ranges(key, [(len(prefix), hs)],
                                              counters=counters)[0]
            h = chunklib.parse_header(prefix)
        else:
            h = chunklib.parse_header(self._engine().fetch_full(key))
        self._header_cache[key] = h
        return h

    def _payload_of(self, idx: int, *, ranged: Optional[bool] = None
                    ) -> Tuple[bytes, Tuple[int, ...], bool]:
        """(payload bytes, shape, is_tiled) for a sample, via open chunk or storage."""
        chunk_name, local = self.encoder.lookup(idx)
        if self._builder is not None and chunk_name == self._open_name:
            b = self._builder
            return (b.payloads[local], tuple(b.shapes[local]),
                    bool(b.flags[local] & FLAG_TILED))
        key = self._chunk_key(chunk_name)
        blob = self._engine().resident(key)
        if blob is not None:  # prefetched chunk: slice locally, no I/O
            header = self._header_of(key, True)
            s, e = header.byte_range(local)
            return blob[s:e], header.shapes[local], header.is_tiled(local)
        if ranged is None:
            ranged = self.vc.storage.kind in ("s3", "lru")
        header = self._header_of(key, ranged)
        s, e = header.byte_range(local)
        # both paths ride the engine: retry policy + request accounting
        payload = (self._engine().fetch_ranges(key, [(s, e)])[0] if ranged
                   else self._engine().fetch_full(key)[s:e])
        return payload, header.shapes[local], header.is_tiled(local)

    def read(self, idx: int, *, ranged: Optional[bool] = None) -> np.ndarray:
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(f"{idx} out of range [0, {n})")
        payload, shape, tiled = self._payload_of(idx, ranged=ranged)
        if tiled:
            return self._assemble_tiled(payload)
        codec = get_codec(self.meta.codec)
        return codec.decode(payload, shape, np.dtype(self.meta.dtype))

    def _assemble_tiled(self, payload: bytes) -> np.ndarray:
        """Reassemble a tiled sample; tile chunks fetched as one batch."""
        desc = TileDescriptor.from_bytes(payload)
        keys = [self._chunk_key(nm) for nm in desc.chunk_names]
        blobs = self._engine().fetch_many(keys)
        return assemble_from_tiles(desc, [blobs[k] for k in keys])

    # ------------------------------------------------------------ batch read
    def read_batch(self, indices: Union[Sequence[int], np.ndarray], *,
                   ranged: Optional[bool] = None,
                   io_stats: Optional[Dict[str, Any]] = None
                   ) -> List[np.ndarray]:
        """Read many samples with at most one coalesced request per chunk.

        The per-sample hot paths (TQL column stacking, the loader's fetch
        units) route through here: indices are grouped by chunk, each
        chunk's sample byte-ranges are fetched as one full GET or one
        coalesced ranged request — whichever the engine's cost model says
        is cheaper — and chunk ``k+1``'s fetch overlaps chunk ``k``'s
        decode on the engine pool.  Output order matches input order;
        duplicate and unsorted indices are fine.

        ``ranged``: None → cost-model decision per chunk; True → always
        ranged reads; False → always whole-chunk GETs.
        ``io_stats``: optional dict accumulating ``io_s``, ``cpu_s``,
        ``bytes``, ``requests`` (the loader feeds these into LoaderStats).
        """
        arr = np.asarray(indices, dtype=np.int64).ravel()
        if arr.size == 0:
            return []
        n = len(self)
        arr = np.where(arr < 0, arr + n, arr)
        ords = self.encoder.ords_of(arr)  # bounds-checks, raises IndexError
        out: List[Optional[np.ndarray]] = [None] * int(arr.size)
        codec = get_codec(self.meta.codec)
        dt = np.dtype(self.meta.dtype)
        engine = self._engine()
        groups: Dict[int, List[int]] = {}
        for j, o in enumerate(ords.tolist()):
            groups.setdefault(int(o), []).append(j)
        tasks = []
        for o in sorted(groups):
            name = self.encoder.name_of(o)
            first, _last = self.encoder.chunk_span(o)
            slots = groups[o]
            if self._builder is not None and name == self._open_name:
                b = self._builder
                for j in slots:
                    local = int(arr[j]) - first
                    if b.flags[local] & FLAG_TILED:
                        out[j] = self._assemble_tiled(b.payloads[local])
                    else:
                        out[j] = codec.decode(b.payloads[local],
                                              tuple(b.shapes[local]), dt)
                continue
            tasks.append((o, name, first, slots))

        def fetch_task(task):
            o, name, first, slots = task
            key = self._chunk_key(name)
            locals_ = sorted({int(arr[j]) - first for j in slots})
            t0 = time.perf_counter()
            header, payloads, nbytes, nreq = self._fetch_chunk_payloads(
                key, name, o, locals_, engine, ranged)
            return header, payloads, nbytes, nreq, time.perf_counter() - t0

        lookahead: Optional[Any] = None
        pipeline = len(tasks) > 1
        try:
            for i, task in enumerate(tasks):
                if lookahead is not None:
                    header, payloads, nbytes, nreq, dt_io = lookahead.result()
                    lookahead = None
                else:
                    header, payloads, nbytes, nreq, dt_io = fetch_task(task)
                if pipeline and i + 1 < len(tasks):
                    # overlap the next chunk's fetch with this chunk's decode
                    lookahead = engine.submit(fetch_task, tasks[i + 1])
                t1 = time.perf_counter()
                _o, _name, first, slots = task
                for j in slots:
                    local = int(arr[j]) - first
                    payload = payloads[local]
                    if header.is_tiled(local):
                        out[j] = self._assemble_tiled(payload)
                    else:
                        out[j] = codec.decode(payload, header.shapes[local],
                                              dt)
                if io_stats is not None:
                    io_stats["io_s"] = io_stats.get("io_s", 0.0) + dt_io
                    io_stats["cpu_s"] = (io_stats.get("cpu_s", 0.0)
                                         + time.perf_counter() - t1)
                    io_stats["bytes"] = io_stats.get("bytes", 0) + nbytes
                    io_stats["requests"] = io_stats.get("requests", 0) + nreq
        finally:
            if lookahead is not None:
                lookahead.cancel()
        return out  # type: ignore[return-value]

    def _fetch_chunk_payloads(self, key: str, cname: str, chunk_ord: int,
                              locals_: List[int], engine: "fetch.FetchEngine",
                              ranged: Optional[bool]):
        """(header, {local: payload}, new_bytes, n_requests) for one chunk."""
        blob = engine.resident(key)
        if blob is None:
            # a deliberate prefetch is coming: wait rather than duplicate it
            blob = engine.wait_inflight(key)
        if blob is not None:
            header = self._header_cache.get(key)
            if header is None:
                header = chunklib.parse_header(blob)
                self._header_cache[key] = header
            return (header,
                    {l: blob[slice(*header.byte_range(l))] for l in locals_},
                    0, 0)
        header = self._header_cache.get(key)
        if ranged is None:
            full = self._full_get_cheaper(key, cname, chunk_ord, locals_,
                                          header, engine)
        else:
            full = not ranged
        if full:
            blob = engine.fetch_full(key)
            header = chunklib.parse_header(blob)
            self._header_cache[key] = header
            return (header,
                    {l: blob[slice(*header.byte_range(l))] for l in locals_},
                    len(blob), 1)
        counters: Dict[str, int] = {"requests": 0, "bytes": 0}
        header = self._header_of(key, True, counters=counters)
        ranges = [header.byte_range(l) for l in locals_]
        payloads = engine.fetch_ranges(key, ranges, counters=counters)
        return (header, dict(zip(locals_, payloads)),
                counters["bytes"], counters["requests"])

    def _full_get_cheaper(self, key: str, cname: str, chunk_ord: int,
                          locals_: List[int], header: Optional[ChunkHeader],
                          engine: "fetch.FetchEngine") -> bool:
        """Cost-model choice between one whole-chunk GET and coalesced
        ranged reads for the ``locals_`` samples of one chunk."""
        if header is not None:
            object_bytes = header.header_size + header.nbytes_data()
            ranges = [header.byte_range(l) for l in locals_]
            spans, _ = coalesce_ranges(ranges, engine.est.gap_threshold())
            needed = sum(e - s for s, e in spans)
            return engine.plan_full_get(
                n_spans=len(spans), needed_bytes=needed,
                object_bytes=object_bytes, header_cached=True)
        st = self.stats.get(cname)
        n_in_chunk = self.encoder.samples_in(chunk_ord)
        if st is not None and st.count:
            # size from the stats sidecar; header estimated at ~26 B/sample
            object_bytes = st.nbytes + 56 + 26 * n_in_chunk
            needed = int(object_bytes * len(locals_) / max(n_in_chunk, 1))
            runs = 1 + sum(b - a > 1
                           for a, b in zip(locals_, locals_[1:]))
            return engine.plan_full_get(
                n_spans=runs, needed_bytes=needed,
                object_bytes=object_bytes, header_cached=False)
        # size unknown (pre-stats dataset): legacy sparse-read heuristic
        return len(locals_) > 2

    def read_region(self, idx: int, region: Sequence[slice],
                    *, ranged: Optional[bool] = None) -> np.ndarray:
        """Partial sample read (§3.5): tiled samples fetch only needed tiles."""
        payload, shape, tiled = self._payload_of(idx, ranged=ranged)
        if tiled:
            desc = TileDescriptor.from_bytes(payload)
            need = tiles_for_region(desc, region)
            blobs = self._engine().fetch_many(
                [self._chunk_key(desc.chunk_names[f]) for f in need])
            payloads = {f: blobs[self._chunk_key(desc.chunk_names[f])]
                        for f in need}
            return assemble_region(desc, region, payloads)
        codec = get_codec(self.meta.codec)
        arr = codec.decode(payload, shape, np.dtype(self.meta.dtype))
        return arr[tuple(region)]

    def chunk_stats_of(self, chunk_ord: int) -> Optional[ChunkStats]:
        """Stats of chunk ``chunk_ord`` (live from the open builder when the
        chunk is still being written), or None when unknown — e.g. datasets
        created before the sidecar existed.  Never touches chunk payloads."""
        name = self.encoder.name_of(chunk_ord)
        if self._builder is not None and name == self._open_name:
            return self._builder.stats_snapshot()
        return self.stats.get(name)

    def shape_of(self, idx: int) -> Tuple[int, ...]:
        """Sample shape without decoding payload (header-only metadata read)."""
        chunk_name, local = self.encoder.lookup(idx)
        if self._builder is not None and chunk_name == self._open_name:
            return tuple(self._builder.shapes[local])
        key = self._chunk_key(chunk_name)
        return tuple(self._header_of(key, self.vc.storage.kind == "s3").shapes[local])

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.read(int(item))
        if isinstance(item, slice):
            return self.read_batch(range(*item.indices(len(self))))
        if isinstance(item, (list, np.ndarray)):
            return self.read_batch([int(i) for i in item])
        raise TypeError(f"bad index {item!r}")

    def numpy(self) -> np.ndarray:
        """Stack into one ndarray (requires fixed shape)."""
        if any(d is None for d in self.shape[1:]):
            raise ValueError(f"tensor {self.name!r} is ragged; use [] access")
        if len(self) == 0:
            return np.zeros((0,), dtype=self.meta.dtype)
        return np.stack(self.read_batch(np.arange(len(self))))

    def text(self, idx: int) -> str:
        return self.read(idx).tobytes().decode()

    # ---------------------------------------------------------- maintenance
    def rechunk(self) -> int:
        """Rewrite all chunks at optimal sizes (§3.5 layout fix); returns #chunks."""
        self.vc.require_writable()
        samples = [(self._payload_of(i), self.sample_ids[i]) for i in range(len(self))]
        # drop current-version chunks we own
        for name in self.encoder.chunk_names():
            if name in self.vc.chunk_set(self.vc.current_id, self.name):
                try:
                    key = self.vc.resolve_chunk_key(self.name, name, None)
                    self.vc.storage.delete(key)
                    self._discard_cached(key)
                except StorageError:
                    pass
                self.vc.forget_chunk(self.name, name)
        self.encoder = ChunkEncoder()
        self._builder, self._open_name = None, None
        self._header_cache.clear()
        ids = []
        for (payload, shape, tiled), sid in samples:
            b = self._ensure_open(len(payload))
            was_empty = b.num_samples == 0
            b.append_raw(payload, shape, FLAG_TILED if tiled else 0)
            if was_empty:
                self.encoder.register_chunk(self._open_name, 1)
            else:
                self.encoder.extend_last(1)
            ids.append(sid)
        self.sample_ids = ids
        self._dirty = True
        self.flush()
        return self.encoder.num_chunks
