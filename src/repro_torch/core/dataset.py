"""Dataset: parallel tensor columns + groups + version control (§3.1, §4.1).

A *sample* is one row indexed across parallel tensors.  Tensors are logically
independent columns (partial column access is what makes streaming selected
tensors cheap).  Groups are syntactic nesting: tensor names may contain ``/``
and a :class:`Group` proxy scopes creation/access, avoiding hierarchical
layout in the format itself (§3.1).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from . import manifest as manifestlib
from .htypes import get_htype, parse_htype
from .storage import (MemoryProvider, StorageError, StorageProvider,
                      storage_from_path)
from .tensor import DEFAULT_MAX_CHUNK, DEFAULT_MIN_CHUNK, Tensor, TensorMeta
from .version_control import VersionControl

DS_META_KEY = "ds_meta.json"


class MergeConflict(RuntimeError):
    pass


class Group:
    """Syntactic-nesting proxy: ``ds.group('a').create_tensor('b')`` == 'a/b'."""

    def __init__(self, ds: "Dataset", prefix: str) -> None:
        self._ds = ds
        self._prefix = prefix.rstrip("/")

    def create_tensor(self, name: str, **kw) -> Tensor:
        return self._ds.create_tensor(f"{self._prefix}/{name}", **kw)

    def __getitem__(self, name: str) -> Tensor:
        return self._ds[f"{self._prefix}/{name}"]

    def group(self, name: str) -> "Group":
        return Group(self._ds, f"{self._prefix}/{name}")

    def tensors(self) -> List[str]:
        p = self._prefix + "/"
        return [t for t in self._ds.tensor_names if t.startswith(p)]


class Dataset:
    def __init__(self, storage: Union[str, StorageProvider, None] = None) -> None:
        if storage is None:
            storage = MemoryProvider()
        elif isinstance(storage, str):
            storage = storage_from_path(storage)
        self.storage = storage
        # manifest-first cold open: the pointer (one GET) carries the format
        # marker and the version tree; its segments carry all per-tensor
        # state, so no per-file probing happens at all.  Legacy datasets
        # (no pointer) keep the per-file path and adopt a manifest on their
        # next commit or via maintenance compaction.
        m = manifestlib.Manifest.load(storage)
        if m is None and storage.get_or_none(DS_META_KEY) is None:
            # brand-new dataset: manifest-native from birth
            storage.put_verified(DS_META_KEY,
                                 json.dumps({"format": "deeplake-repro-v1"}).encode())
            m = manifestlib.Manifest.create(storage)
        self.vc = VersionControl(storage, manifest=m)
        self._tensors: Dict[str, Tensor] = {}

    @property
    def manifest(self):
        """The dataset manifest (None on a legacy per-file dataset)."""
        return self.vc.manifest

    def maintenance(self) -> "maintenance.MaintenanceRunner":
        """Background-maintenance entry point: stats backfill, manifest
        compaction, orphan-chunk GC (:mod:`repro.core.maintenance`)."""
        from . import maintenance
        return maintenance.MaintenanceRunner(self)

    # ----------------------------------------------------------------- schema
    @property
    def tensor_names(self) -> List[str]:
        return self.vc.schema_tensors()

    @property
    def groups(self) -> List[str]:
        seen = set()
        for t in self.tensor_names:
            parts = t.split("/")[:-1]
            for i in range(1, len(parts) + 1):
                seen.add("/".join(parts[:i]))
        return sorted(seen)

    def group(self, name: str) -> Group:
        return Group(self, name)

    def create_tensor(self, name: str, htype: str = "generic",
                      dtype: Optional[str] = None,
                      sample_compression: Optional[str] = None,
                      min_chunk_size: int = DEFAULT_MIN_CHUNK,
                      max_chunk_size: int = DEFAULT_MAX_CHUNK,
                      strict: bool = True) -> Tensor:
        self.vc.require_writable()
        if name in self.tensor_names:
            raise ValueError(f"tensor {name!r} exists")
        parse_htype(htype)  # validate
        spec = get_htype(htype)
        meta = TensorMeta(
            htype=htype,
            dtype=dtype or spec.default_dtype,
            codec=sample_compression or spec.default_codec,
            min_chunk_size=min_chunk_size,
            max_chunk_size=max_chunk_size,
            strict=strict,
        )
        t = Tensor(name, self.vc, meta=meta)
        self.vc.set_schema_tensors(self.tensor_names + [name])
        self.vc.record_created(name)
        self._tensors[name] = t
        t.flush()
        return t

    def delete_tensor(self, name: str) -> None:
        """Schema evolution: drop a column in the current version."""
        self.vc.require_writable()
        names = self.tensor_names
        if name not in names:
            raise KeyError(name)
        names.remove(name)
        self.vc.set_schema_tensors(names)
        self._tensors.pop(name, None)

    # ----------------------------------------------------------------- access
    def _tensor(self, name: str) -> Tensor:
        if name not in self._tensors:
            if name not in self.tensor_names:
                raise KeyError(f"no tensor {name!r}; have {self.tensor_names}")
            self._tensors[name] = Tensor(name, self.vc)
        return self._tensors[name]

    @property
    def tensors(self) -> Dict[str, Tensor]:
        return {n: self._tensor(n) for n in self.tensor_names}

    def __getitem__(self, item):
        if isinstance(item, str):
            return self._tensor(item)
        from .views import DatasetView
        n = len(self)
        if isinstance(item, (int, np.integer)):
            return DatasetView(self, np.asarray([int(item) % n if item < 0 else int(item)]))
        if isinstance(item, slice):
            return DatasetView(self, np.arange(*item.indices(n)))
        if isinstance(item, (list, np.ndarray)):
            return DatasetView(self, np.asarray(item, dtype=np.int64))
        raise TypeError(f"bad index {item!r}")

    def __getattr__(self, name: str) -> Tensor:
        # attribute access for tensors: ds.images
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._tensor(name)
        except KeyError:
            raise AttributeError(name) from None

    def __len__(self) -> int:
        return max((len(t) for t in self.tensors.values()), default=0)

    @property
    def min_len(self) -> int:
        return min((len(t) for t in self.tensors.values()), default=0)

    def append(self, row: Dict[str, Any]) -> int:
        """Append one row across tensors; returns the new row index."""
        unknown = set(row) - set(self.tensor_names)
        if unknown:
            raise KeyError(f"unknown tensors in row: {sorted(unknown)}")
        idx = -1
        for name, value in row.items():
            idx = self._tensor(name).append(value)
        return idx

    def extend(self, rows: Union[Dict[str, Sequence[Any]], Sequence[Dict[str, Any]]]) -> None:
        if isinstance(rows, dict):
            lengths = {len(v) for v in rows.values()}
            if len(lengths) > 1:
                raise ValueError("column lengths differ")
            n = lengths.pop() if lengths else 0
            for i in range(n):
                self.append({k: v[i] for k, v in rows.items()})
        else:
            for r in rows:
                self.append(r)

    def read_row(self, idx: int, tensors: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        names = list(tensors) if tensors else self.tensor_names
        return {n: self._tensor(n).read(idx) for n in names}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.min_len):
            yield self.read_row(i)

    # ------------------------------------------------------------------ I/O
    def flush(self) -> None:
        for t in self._tensors.values():
            t.flush()
        self.vc.save_info()

    # -------------------------------------------------------------- version control
    def commit(self, message: str = "") -> str:
        # flush is passed as a callback so the rebase-and-retry loop in
        # VersionControl.commit can re-run it after relocating the head
        # (a conflicting foreign commit can surface *during* flush, at the
        # first put_state -> mark_stale fence).
        sealed = self.vc.commit(message, flush=self.flush)
        self._tensors.clear()  # state moved to the new head
        return sealed

    def checkout(self, ref: str, create: bool = False) -> str:
        self.flush()
        nid = self.vc.checkout(ref, create=create)
        self._tensors.clear()
        return nid

    @property
    def branch(self) -> str:
        return self.vc.current.branch

    @property
    def commit_id(self) -> str:
        return self.vc.current_id

    @property
    def branches(self) -> List[str]:
        return sorted(self.vc.branches)

    def log(self):
        return self.vc.log()

    def diff(self, ref_a: Optional[str] = None, ref_b: Optional[str] = None):
        self.flush()
        a = ref_a or self.vc.current_id
        b = ref_b or self.vc.current_id
        return self.vc.diff_between(a, b)

    def tensor_at(self, name: str, ref: str) -> Tensor:
        """Read-only tensor bound to another version (time travel)."""
        return Tensor(name, self.vc, node_id=self.vc.resolve_ref(ref))

    # ------------------------------------------------------------------ merge
    def merge(self, ref: str, policy: str = "theirs") -> str:
        """Merge ``ref`` into the current branch (§4.1).

        Sample identity is by sample id.  Conflicts (same sample updated on
        both sides since the LCA) resolve per ``policy``:
        ``theirs`` | ``ours`` | ``raise``.
        """
        if policy not in ("theirs", "ours", "raise"):
            raise ValueError(f"bad policy {policy!r}")
        self.vc.require_writable()
        self.flush()
        src_id = self.vc.resolve_ref(ref)
        diffs = self.vc.diff_between(self.vc.current_id, src_id)
        theirs_all, ours_all = diffs["b"], diffs["a"]
        src_tensors = self.vc.schema_tensors(src_id)
        for tname in src_tensors:
            src_t = Tensor(tname, self.vc, node_id=src_id)
            if tname not in self.tensor_names:
                # tensor created on src: adopt schema + all rows
                meta = TensorMeta.from_json(src_t.meta.to_json())
                meta.min_shape = meta.max_shape = None
                dst = Tensor(tname, self.vc, meta=meta)
                self.vc.set_schema_tensors(self.tensor_names + [tname])
                self.vc.record_created(tname)
                self._tensors[tname] = dst
                for i in range(len(src_t)):
                    dst.append(src_t.read(i), sample_id=src_t.sample_ids[i])
                dst.flush()
                continue
            dst = self._tensor(tname)
            their_d = theirs_all.get(tname)
            if not their_d:
                continue
            our_d = ours_all.get(tname, {})
            ours_ids = {dst.sample_ids[i]: i for i in range(len(dst))}
            our_updated_ids = {dst.sample_ids[i] for i in our_d.get("updated", [])
                               if i < len(dst)}
            # 1) their appends -> append if id unseen
            first, count = their_d.get("added_first", -1), their_d.get("added_count", 0)
            if count:
                for i in range(first, first + count):
                    sid = src_t.sample_ids[i]
                    if sid not in ours_ids:
                        dst.append(src_t.read(i), sample_id=sid)
            # 2) their updates -> apply by id, respecting policy on conflict
            for i in their_d.get("updated", []):
                if i >= len(src_t):
                    continue
                sid = src_t.sample_ids[i]
                if sid not in ours_ids:
                    continue
                if sid in our_updated_ids:
                    if policy == "raise":
                        raise MergeConflict(
                            f"tensor {tname!r}: sample id {sid} updated on both sides")
                    if policy == "ours":
                        continue
                dst[ours_ids[sid]] = src_t.read(i)
            dst.flush()
        return self.commit(f"merge {ref!r} into {self.branch!r}")

    # ------------------------------------------------------------------ query
    def query(self, tql: str, engine: str = "auto", use_stats: bool = True,
              stream: Optional[bool] = None, shards: Optional[int] = None,
              tenant: Optional[str] = None):
        """Run a TQL query.  ``stream``: None = auto (WHERE evaluates per
        chunk group on the scan pipeline when the view spans several
        groups), False = whole-view column stack, True = force streaming.
        ``shards`` > 1 runs the per-chunk-group scan shard-parallel.  All
        modes return byte-identical result sets.  ``tenant`` tags the
        scan's prefetches for the engine's fair scheduler."""
        from .tql import execute_query
        return execute_query(self, tql, engine=engine, use_stats=use_stats,
                             stream=stream, shards=shards, tenant=tenant)

    def dataloader(self, **kw):
        from .dataloader import DeepLakeLoader
        from .views import DatasetView
        return DeepLakeLoader(DatasetView.full(self), **kw)

    def pytorch_like(self, **kw):
        return self.dataloader(**kw)

    # ------------------------------------------------------------------ misc
    def summary(self) -> str:
        lines = [f"Dataset @ {self.storage.kind} | branch={self.branch} "
                 f"head={self.commit_id[:8]} rows={len(self)}"]
        for n, t in sorted(self.tensors.items()):
            lines.append(f"  {n:24s} {t.htype:16s} {str(t.dtype):8s} "
                         f"shape={t.shape} chunks={t.num_chunks}")
        return "\n".join(lines)


def dataset(storage: Union[str, StorageProvider, None] = None) -> Dataset:
    """Public constructor, mirroring ``deeplake.dataset(path)``."""
    return Dataset(storage)


def empty_like(ds: Dataset, storage: Union[str, StorageProvider, None] = None) -> Dataset:
    out = Dataset(storage)
    for name, t in ds.tensors.items():
        out.create_tensor(name, htype=t.meta.htype, dtype=t.meta.dtype,
                          sample_compression=t.meta.codec,
                          min_chunk_size=t.meta.min_chunk_size,
                          max_chunk_size=t.meta.max_chunk_size,
                          strict=t.meta.strict)
    return out
