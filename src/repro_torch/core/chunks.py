"""Chunk binary format (§3.4).

A chunk is a binary blob holding a contiguous run of samples of one tensor:

    magic      4s   b"DLC1"
    header_sz  u32  byte offset where the data section begins
    n_samples  u32
    max_ndim   u8 + 3 pad bytes
    dtype      16s  zero-padded numpy dtype string
    codec      16s  zero-padded codec name
    offsets    u64[n+1]       encoded-payload offsets *within the data section*
    flags      u8[n]          bit0: payload is a tile descriptor, not data
    ndims      u8[n]
    shapes     u32[n*max_ndim] row-major, zero-padded to max_ndim
    data       bytes          concatenated per-sample codec payloads

Byte ranges for a single sample are therefore
``[header_sz + offsets[i], header_sz + offsets[i+1])`` — this is what the
streaming loader's range requests use (§3.5).  Shapes live in the header so
shape-only queries (TQL ``SHAPE(x)``) never touch payload bytes.

Chunk statistics (TQL data skipping)
-----------------------------------

Alongside the wire format, each :class:`ChunkBuilder` accumulates a
:class:`ChunkStats` record over every sample it absorbs: element-wise
``lo``/``hi`` bounds (widened outward so float rounding can never narrow the
true range), NaN and non-zero element counts, total element count, the
smallest per-sample element count (``min_elems`` — 0 means the chunk may hold
empty samples), sample count and payload byte size.  Samples the builder
cannot inspect (undecodable payloads, or tile descriptors absorbed without
their source array — e.g. a copy-on-write chunk rewrite) flip ``exact`` to
False, which tells the query planner to treat the chunk as unknown.  On the
append path tiled samples stay exact: the tensor hands the builder the
reassembled array a reader would decode.

Membership sketches (equality / IN / CONTAINS pushdown)
-------------------------------------------------------

Bounds answer range predicates; ``=`` / ``IN`` / ``CONTAINS`` need
*membership*.  The accumulator therefore also tracks a per-chunk value
sketch over one of two domains, chosen by dtype:

* ``dom="int"`` — every element value of bool/int samples (``class_label``,
  ``tokens``, masks), provided each sample has ≤ ``SKETCH_MAX_ELEMS``
  elements (keeps the ingest path cheap; larger samples disable the
  sketch for the whole chunk);
* ``dom="str"`` — the whole decoded sample string of 1-D ``uint8``
  samples ≤ ``SKETCH_MAX_STR`` bytes (the ``text`` htype), decoded with
  ``errors="replace"`` — the *same* decode TQL's ``CONTAINS`` applies, so
  substring verdicts from the sketch can never diverge from execution.

Float samples never sketch (rounding makes equality pruning unsound).
Wire form, inside each sidecar record:

* ``≤ SKETCH_DICT_MAX`` (64) distinct values → ``dct`` holds the exact
  sorted value list and no bloom is stored (the dictionary subsumes it);
* ``≤ SKETCH_MAX_DISTINCT`` (256) distinct, ``int`` domain only → ``dct``
  is null and ``bloom`` holds a hex ``SKETCH_BLOOM_BYTES``-byte bloom
  filter (``SKETCH_BLOOM_K`` blake2b-derived probes per value); a
  ``str``-domain dictionary that overflows drops the sketch instead —
  substring probes need the exact values, a bloom of whole strings
  answers nothing;
* more distinct values, oversized samples, or a non-sketchable dtype →
  both null (``dom`` null too).

``sketched`` marks records written by a sketch-aware writer: legacy
records deserialize with ``sketched=False`` so ``backfill_stats`` knows
to lift them (a null sketch on a *sketched* record is a definitive
"inapplicable", not a gap).  Soundness rules consumed by the planner
(:meth:`ChunkStats.might_contain`):

* a sketch is consulted only when the record is ``exact`` and
  ``sketched`` and the probe value matches the sketch domain;
* ``might_contain`` may return false positives (cost: a verify verdict)
  but never false negatives: the dictionary is the exact distinct-value
  set, and the bloom only ever *adds* bits — so "absent" is a proof;
* empty samples contribute no values; membership verdicts must therefore
  derive the empty-sample outcome from ``min_elems``, never the sketch.

Partial aggregates (GROUP BY / aggregate pushdown)
--------------------------------------------------

TQL's aggregation path can answer COUNT/SUM/MIN/MAX/AVG for a chunk
straight from its stats record — zero payload fetches — but only under
rules as strict as the sketch rules above, because a partial aggregate
that is merely *approximate* silently corrupts the merged total (there is
no "verify" second chance once a number is folded in):

* the record must be ``exact`` and the querying view must cover **every**
  row of the chunk exactly once — a partially covered chunk must be
  fetched and folded instead (its stats describe rows the query excluded);
* ``COUNT`` needs only the covered row count; ``SUM`` uses the ``sum``
  field (None on legacy records → fetch+fold), accumulated NaN-skipping
  in float64 for float dtypes and exactly (native integer width) for
  bool/int dtypes; ``AVG`` is ``sum / (n_elements - nan_count)``;
* ``MIN``/``MAX`` use ``lo``/``hi`` only while ``|lo|``/``|hi|`` < 2**53:
  beyond that the outward float widening that keeps *pruning* sound makes
  the bounds unusable as *values* (they may not equal any element);
* a chunk with no numeric values (all samples empty, or all elements NaN)
  contributes the fold identities: 0 to COUNT-of-elements-style sums,
  nothing to MIN/MAX/AVG;
* the grouped fast path additionally requires the grouping key chunk to
  be single-valued: an exact dictionary sketch with exactly one entry and
  scalar samples (``min_elems == 1 and n_elements == count``, no NaNs for
  the int domain), so every row of the chunk provably belongs to that one
  group.

Stats are persisted per tensor per version as a JSON sidecar under the
existing :class:`~repro.core.storage.StorageProvider` key protocol:

    versions/{node}/tensors/{t}/chunk_stats.json
        {"chunks": {chunk_name: {count, nbytes, lo, hi, sum, nan_count,
                                 true_count, n_elements, min_elems, exact,
                                 sketched, dom, dct, bloom}}}

The sidecar is one of the version-control ``STATE_FILES``: ``commit`` copies
it to the child node together with the chunk-encoder snapshot, so stats keep
mapping chunk *names* (which never move between versions, §4.1) to bounds.
``tql/planner.py`` consumes these records to derive per-chunk
prune/keep/verify verdicts for ``WHERE`` clauses without fetching payloads,
and per-chunk ``ORDER BY`` key bounds for top-k chunk skipping.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .codecs import Codec, get_codec

MAGIC = b"DLC1"
FLAG_TILED = 0x01
_FIXED = struct.Struct("<4sIIB3x16s16s")  # magic, header_sz, n, max_ndim, dtype, codec

_NUMERIC_KINDS = "biuf"

# ---- membership-sketch parameters (see module docstring for the format)
SKETCH_DICT_MAX = 64        # exact dictionary capacity (distinct values)
SKETCH_MAX_DISTINCT = 256   # beyond this the bloom is saturated: disable
SKETCH_BLOOM_BYTES = 128    # 1024-bit filter
SKETCH_BLOOM_K = 4          # probes per value
SKETCH_MAX_ELEMS = 4096     # int-domain samples larger than this don't sketch
SKETCH_MAX_STR = 256        # str-domain (uint8 text) sample byte cap


def _sketch_encode(value: Union[int, str]) -> bytes:
    """Canonical hash input of a sketch value; the domain prefix keeps the
    int and str value spaces collision-free."""
    if isinstance(value, str):
        return b"s:" + value.encode("utf-8", "replace")
    return b"i:%d" % int(value)


def _bloom_positions(value: Union[int, str]) -> List[int]:
    d = hashlib.blake2b(_sketch_encode(value), digest_size=16).digest()
    nbits = SKETCH_BLOOM_BYTES * 8
    return [int.from_bytes(d[4 * i:4 * i + 4], "big") % nbits
            for i in range(SKETCH_BLOOM_K)]


def _bloom_add(bits: bytearray, value: Union[int, str]) -> None:
    for p in _bloom_positions(value):
        bits[p >> 3] |= 1 << (p & 7)


def bloom_might_contain(bloom_hex: str, value: Union[int, str]) -> bool:
    """True unless the filter proves ``value`` was never inserted."""
    bits = bytes.fromhex(bloom_hex)
    return all(bits[p >> 3] & (1 << (p & 7)) for p in _bloom_positions(value))


def _lo_bound(v) -> float:
    """float(v) rounded, if at all, toward -inf (never narrows an interval)."""
    f = float(v)
    return float(np.nextafter(f, -np.inf)) if f > v else f


def _hi_bound(v) -> float:
    f = float(v)
    return float(np.nextafter(f, np.inf)) if f < v else f


@dataclass
class ChunkStats:
    """Per-chunk column statistics used for TQL data skipping.

    ``lo``/``hi`` bound every non-NaN element of every sample in the chunk
    (None when the chunk holds no inspectable numeric values).  ``exact`` is
    False when at least one sample could not be inspected (undecodable
    payload, or a tile descriptor seen without its source array) — the
    planner must then treat the chunk as unknown.

    ``dom``/``dct``/``bloom`` are the membership sketch (module docstring:
    value domains, capacities, soundness rules); ``sketched`` distinguishes
    "sketch-aware writer decided no sketch applies" from "record predates
    sketches" so the maintenance backfill can lift legacy records.
    """

    count: int = 0          # samples
    nbytes: int = 0         # encoded payload bytes
    lo: Optional[float] = None
    hi: Optional[float] = None
    #: NaN-skipping total of every numeric element (float64 accumulation
    #: for float dtypes, exact native-integer for bool/int); 0 when the
    #: chunk has no numeric values, None on inexact or legacy records.
    #: Consumed by the aggregate fast path (module docstring).
    sum: Optional[float] = None
    nan_count: int = 0      # NaN elements seen
    true_count: int = 0     # non-zero elements seen
    n_elements: int = 0     # total elements across samples
    min_elems: int = 0      # smallest per-sample element count
    exact: bool = True
    sketched: bool = False  # record written by a sketch-aware writer
    dom: Optional[str] = None            # 'int' | 'str' | None
    dct: Optional[List] = None           # exact distinct values (sorted)
    bloom: Optional[str] = None          # hex bloom (dct overflowed)

    def to_json(self) -> dict:
        return {"count": self.count, "nbytes": self.nbytes,
                "lo": self.lo, "hi": self.hi, "sum": self.sum,
                "nan_count": self.nan_count, "true_count": self.true_count,
                "n_elements": self.n_elements, "min_elems": self.min_elems,
                "exact": self.exact, "sketched": self.sketched,
                "dom": self.dom, "dct": self.dct, "bloom": self.bloom}

    @classmethod
    def from_json(cls, d: dict) -> "ChunkStats":
        s = cls()
        for k, v in d.items():
            setattr(s, k, v)
        return s

    # ---- membership (sound: False positives allowed, negatives never)
    def sketch_usable(self, dom: str) -> bool:
        """True when membership probes over domain ``dom`` may consult this
        record's sketch (exact, sketch-aware, same value domain)."""
        return (self.exact and self.sketched and self.dom == dom
                and (self.dct is not None or self.bloom is not None))

    def might_contain(self, value: Union[int, str]) -> bool:
        """Sound membership: False ⇒ ``value`` appears in *no* sample of the
        chunk (its domain: elements for ``int``, whole sample strings for
        ``str``).  True means present *or unknown* — including any probe the
        sketch cannot answer (wrong domain, inexact, legacy record)."""
        dom = "str" if isinstance(value, str) else "int"
        if not self.sketch_usable(dom):
            return True
        if self.dct is not None:
            return value in self.dct
        return bloom_might_contain(self.bloom, value)


class _StatsAccumulator:
    """Streaming ChunkStats over decoded samples of one chunk."""

    def __init__(self, dtype: np.dtype) -> None:
        self.dtype = dtype
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.lo = np.inf
        self.hi = -np.inf
        self.sum = 0                    # Python int/float: exact for ints
        self.nan_count = 0
        self.true_count = 0
        self.n_elements = 0
        self.min_elems: Optional[int] = None
        self.exact = True
        self._values: set = set()       # distinct sketch values so far
        self._dom: Optional[str] = None
        self._sketch_ok = True

    def mark_inexact(self, n_samples: int = 1) -> None:
        self.count += n_samples
        self.exact = False

    def _disable_sketch(self) -> None:
        self._sketch_ok = False
        self._values = set()
        self._dom = None

    def _sketch_sample(self, arr: np.ndarray, kind: str) -> None:
        """Fold one sample's values into the membership sketch (or disable
        it for the chunk when the sample falls outside the sketchable
        envelope — see the module docstring's domain rules)."""
        if not self._sketch_ok:
            return
        if kind == "f":  # float equality pruning is never sound
            self._disable_sketch()
            return
        if kind == "u" and arr.dtype.itemsize == 1:
            # text htype domain: the whole decoded sample string, with the
            # same lossy decode CONTAINS applies at execution time
            if arr.ndim != 1 or arr.size > SKETCH_MAX_STR:
                self._disable_sketch()
                return
            self._values.add(
                np.ascontiguousarray(arr).tobytes().decode(errors="replace"))
            dom = "str"
        else:
            if arr.size > SKETCH_MAX_ELEMS:
                self._disable_sketch()
                return
            self._values.update(int(v) for v in np.unique(arr))
            dom = "int"
        if self._dom is None:
            self._dom = dom
        elif self._dom != dom:          # mixed domains: cannot happen for a
            self._disable_sketch()      # fixed-dtype tensor, but stay sound
            return
        if len(self._values) > SKETCH_MAX_DISTINCT:
            self._disable_sketch()

    def observe(self, arr: np.ndarray) -> None:
        self.count += 1
        size = int(arr.size)
        self.n_elements += size
        self.min_elems = size if self.min_elems is None \
            else min(self.min_elems, size)
        if size == 0:
            return
        self.true_count += int(np.count_nonzero(arr))
        kind = arr.dtype.kind
        if kind not in _NUMERIC_KINDS:
            self.exact = False
            self._disable_sketch()
            return
        self._sketch_sample(arr, kind)
        if kind == "f":
            nan = size - int(np.count_nonzero(arr == arr))
            self.nan_count += nan
            if nan == size:
                return
            self.sum += float(np.nansum(arr, dtype=np.float64))
            lo, hi = float(np.nanmin(arr)), float(np.nanmax(arr))
        else:
            # per-sample native-width sum, cross-sample Python-int (exact)
            self.sum += int(arr.sum(dtype=np.uint64 if kind == "u"
                                    else np.int64))
            lo = _lo_bound(int(arr.min()))
            hi = _hi_bound(int(arr.max()))
        self.lo = min(self.lo, lo)
        self.hi = max(self.hi, hi)

    def _sketch_snapshot(self) -> Tuple[Optional[str], Optional[List],
                                        Optional[str]]:
        """(dom, dct, bloom) wire triple: exact dictionary while it fits,
        bloom beyond that, nothing once saturated/inapplicable.  The bloom
        is int-domain only — every str-domain consumer (CONTAINS substring
        probes) needs the exact dictionary, so a bloom of whole strings
        would be unreachable payload."""
        if not self._sketch_ok or self._dom is None:
            return None, None, None
        values = sorted(self._values)
        if len(values) <= SKETCH_DICT_MAX:
            return self._dom, values, None
        if self._dom != "int":
            return None, None, None
        bits = bytearray(SKETCH_BLOOM_BYTES)
        for v in values:
            _bloom_add(bits, v)
        return self._dom, None, bytes(bits).hex()

    def snapshot(self, nbytes: int) -> ChunkStats:
        has_range = self.lo <= self.hi
        dom, dct, bloom = self._sketch_snapshot()
        return ChunkStats(
            count=self.count, nbytes=int(nbytes),
            lo=self.lo if has_range else None,
            hi=self.hi if has_range else None,
            sum=self.sum if self.exact else None,
            nan_count=self.nan_count, true_count=self.true_count,
            n_elements=self.n_elements,
            min_elems=int(self.min_elems or 0),
            exact=self.exact, sketched=True,
            dom=dom, dct=dct, bloom=bloom)


def _pad16(s: str) -> bytes:
    b = s.encode()
    if len(b) > 16:
        raise ValueError(f"name too long: {s}")
    return b.ljust(16, b"\x00")


@dataclass
class ChunkHeader:
    num_samples: int
    max_ndim: int
    dtype: str
    codec: str
    offsets: np.ndarray  # (n+1,) u64
    flags: np.ndarray    # (n,)  u8
    shapes: List[Tuple[int, ...]]
    header_size: int

    def byte_range(self, i: int) -> Tuple[int, int]:
        """Absolute [start, end) byte range of sample ``i`` inside the chunk."""
        return (self.header_size + int(self.offsets[i]),
                self.header_size + int(self.offsets[i + 1]))

    def is_tiled(self, i: int) -> bool:
        return bool(self.flags[i] & FLAG_TILED)

    def nbytes_data(self) -> int:
        return int(self.offsets[-1])


def header_size_of(raw_prefix: bytes) -> int:
    """Given ≥12 leading bytes of a chunk, return its header size."""
    magic, header_sz, _n, _ndim, _dt, _cd = _FIXED.unpack_from(
        raw_prefix[:_FIXED.size].ljust(_FIXED.size, b"\x00"))
    if magic != MAGIC:
        raise ValueError("not a Deep Lake chunk")
    return header_sz


def parse_header(raw: bytes) -> ChunkHeader:
    magic, header_sz, n, max_ndim, dtype_b, codec_b = _FIXED.unpack_from(raw)
    if magic != MAGIC:
        raise ValueError("not a Deep Lake chunk")
    off = _FIXED.size
    offsets = np.frombuffer(raw, dtype="<u8", count=n + 1, offset=off)
    off += 8 * (n + 1)
    flags = np.frombuffer(raw, dtype="u1", count=n, offset=off)
    off += n
    ndims = np.frombuffer(raw, dtype="u1", count=n, offset=off)
    off += n
    shp = np.frombuffer(raw, dtype="<u4", count=n * max_ndim, offset=off)
    shp = shp.reshape(n, max_ndim) if n else shp.reshape(0, max(max_ndim, 1))
    shapes = [tuple(int(x) for x in shp[i, : ndims[i]]) for i in range(n)]
    return ChunkHeader(
        num_samples=n,
        max_ndim=max_ndim,
        dtype=dtype_b.rstrip(b"\x00").decode(),
        codec=codec_b.rstrip(b"\x00").decode(),
        offsets=offsets,
        flags=flags,
        shapes=shapes,
        header_size=header_sz,
    )


class ChunkBuilder:
    """Accumulates samples, then serializes to the chunk wire format.

    The builder tracks its *serialized* size so the tensor can honor the
    [min_chunk_size, max_chunk_size] policy from §3.4 while appending.
    """

    def __init__(self, dtype: str, codec: str) -> None:
        self.dtype = np.dtype(dtype)
        self.codec_name = codec
        self._codec: Codec = get_codec(codec)
        self.payloads: List[bytes] = []
        self.shapes: List[Tuple[int, ...]] = []
        self.flags: List[int] = []
        self._data_bytes = 0
        self._stats = _StatsAccumulator(self.dtype)
        self._stats_dirty = False

    # -- building ------------------------------------------------------------
    def append_array(self, arr: np.ndarray) -> int:
        """Encode + append an ndarray sample; returns its encoded size."""
        if arr.dtype != self.dtype:
            raise TypeError(f"chunk dtype {self.dtype} != sample dtype {arr.dtype}")
        payload = self._codec.encode(arr)
        self._append_payload(payload, tuple(arr.shape), 0)
        if self._codec.lossy:  # stats must bound what queries will read
            self._observe_payload(payload, tuple(arr.shape), 0)
        else:
            self._stats.observe(arr)
        return len(payload)

    def append_raw(self, payload: bytes, shape: Tuple[int, ...], flags: int = 0,
                   source: Optional[np.ndarray] = None) -> int:
        """Append a pre-encoded payload (used for tile descriptors / copies).

        ``source`` is the decoded array the payload represents, when the
        caller still has it in hand.  For lossless non-tiled payloads its
        stats equal the payload's, so passing it skips a decode on the
        ingest hot path (lossy codecs re-decode — stats must bound what
        queries will read).  For FLAG_TILED payloads the caller guarantees
        ``source`` is the array a reader reassembles from the tiles
        (``Tensor._write_tiled`` hands back the lossy round-trip), which
        keeps tiled chunks *exact* instead of degrading them to planner
        'verify'.
        """
        payload = bytes(payload)
        self._append_payload(payload, shape, flags)
        if source is not None and (flags & FLAG_TILED
                                   or not self._codec.lossy):
            self._stats.observe(source)
        else:
            self._observe_payload(payload, shape, flags)
        return len(payload)

    def replace_payload(self, local: int, payload: bytes,
                        shape: Tuple[int, ...], flags: int) -> None:
        """In-place sample update of the open chunk; stats recompute lazily."""
        self._data_bytes += len(payload) - len(self.payloads[local])
        self.payloads[local] = bytes(payload)
        self.shapes[local] = shape
        self.flags[local] = flags
        self._stats_dirty = True

    def _append_payload(self, payload: bytes, shape: Tuple[int, ...], flags: int) -> None:
        self.payloads.append(payload)
        self.shapes.append(shape)
        self.flags.append(flags)
        self._data_bytes += len(payload)

    # -- statistics ----------------------------------------------------------
    def _observe_payload(self, payload: bytes, shape: Tuple[int, ...],
                         flags: int) -> None:
        if flags & FLAG_TILED:
            self._stats.mark_inexact()
            return
        try:
            self._stats.observe(self._codec.decode(payload, shape, self.dtype))
        except Exception:
            self._stats.mark_inexact()

    def stats_snapshot(self) -> ChunkStats:
        """Current :class:`ChunkStats` of the chunk being built."""
        if self._stats_dirty:
            self._stats.reset()
            for payload, shape, flags in zip(self.payloads, self.shapes,
                                             self.flags):
                self._observe_payload(payload, shape, flags)
            self._stats_dirty = False
        return self._stats.snapshot(self._data_bytes)

    # -- inspection ------------------------------------------------------------
    @property
    def num_samples(self) -> int:
        return len(self.payloads)

    @property
    def max_ndim(self) -> int:
        return max((len(s) for s in self.shapes), default=1)

    def nbytes_serialized(self) -> int:
        n = self.num_samples
        return (_FIXED.size + 8 * (n + 1) + 2 * n + 4 * n * self.max_ndim
                + self._data_bytes)

    # -- wire ------------------------------------------------------------
    def serialize(self) -> bytes:
        n = self.num_samples
        max_ndim = self.max_ndim
        offsets = np.zeros(n + 1, dtype="<u8")
        np.cumsum([len(p) for p in self.payloads], out=offsets[1:])
        ndims = np.array([len(s) for s in self.shapes], dtype="u1")
        shp = np.zeros((n, max_ndim), dtype="<u4")
        for i, s in enumerate(self.shapes):
            shp[i, : len(s)] = s
        header_sz = _FIXED.size + 8 * (n + 1) + 2 * n + 4 * n * max_ndim
        parts = [
            _FIXED.pack(MAGIC, header_sz, n, max_ndim,
                        _pad16(self.dtype.str if self.dtype.names is None else self.dtype.name),
                        _pad16(self.codec_name)),
            offsets.tobytes(),
            np.asarray(self.flags, dtype="u1").tobytes(),
            ndims.tobytes(),
            shp.tobytes(),
        ]
        parts.extend(self.payloads)
        return b"".join(parts)


def decode_sample(header: ChunkHeader, payload: bytes, i: int) -> np.ndarray:
    """Decode sample ``i``'s payload bytes (already range-read) to ndarray."""
    codec = get_codec(header.codec)
    return codec.decode(payload, header.shapes[i], np.dtype(header.dtype))


def read_sample_from_bytes(raw: bytes, i: int,
                           header: Optional[ChunkHeader] = None) -> np.ndarray:
    """Decode sample ``i`` from a fully-fetched chunk blob."""
    h = header or parse_header(raw)
    s, e = h.byte_range(i)
    return decode_sample(h, raw[s:e], i)


def read_all_samples(raw: bytes) -> List[np.ndarray]:
    h = parse_header(raw)
    return [read_sample_from_bytes(raw, i, h) for i in range(h.num_samples)]
