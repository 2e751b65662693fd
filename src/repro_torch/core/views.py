"""Dataset views (§4.3/§4.4): an index subset of a dataset at a version.

Query results are views; views stream into the dataloader or materialize into
a new optimally-chunked dataset.  Views can be persisted (id -> indices) so a
training run can record exactly which rows it consumed (data lineage).
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .tensor import Tensor


class TensorView:
    def __init__(self, tensor: Tensor, indices: np.ndarray) -> None:
        self.tensor = tensor
        self.indices = indices

    def __len__(self) -> int:
        return len(self.indices)

    def read(self, i: int) -> np.ndarray:
        return self.tensor.read(int(self.indices[i]))

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.read(int(item))
        return [self.read(int(i)) for i in np.arange(len(self))[item]]

    def numpy(self) -> np.ndarray:
        return np.stack(self.tensor.read_batch(self.indices)) if len(self) \
            else np.zeros((0,), dtype=self.tensor.meta.dtype)

    @property
    def name(self) -> str:
        return self.tensor.name


class DatasetView:
    """Row subset of a dataset (optionally at a non-head version)."""

    #: scan-planner report attached by the TQL executor when chunk-statistics
    #: pushdown ran for this view's query (dict, see ScanPlan.report()); the
    #: dataloader reads it to account pruned chunks in LoaderStats.
    scan_plan = None
    #: top-k report attached when ORDER BY + LIMIT ran as a best-bound-first
    #: streamed scan (dict: groups, groups_scanned, groups_skipped, ...);
    #: the dataloader accounts skipped groups like pruned chunks.
    topk_plan = None

    def __init__(self, dataset, indices: np.ndarray,
                 node_id: Optional[str] = None,
                 tensors: Optional[Sequence[str]] = None,
                 derived: Optional[Dict[str, List[Any]]] = None) -> None:
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.node_id = node_id
        self._tensor_names = list(tensors) if tensors is not None else None
        # computed columns produced by a query's SELECT expressions
        self.derived = derived or {}
        self._bound: Dict[str, Tensor] = {}

    # ------------------------------------------------------------- factory
    @classmethod
    def full(cls, dataset, node_id: Optional[str] = None) -> "DatasetView":
        """All rows of ``dataset`` at a version.  Row counts come from the
        manifest's column-statistics section when the node is covered, so
        opening the full view of a committed dataset binds no tensors."""
        names = dataset.vc.schema_tensors(node_id)
        lengths = []
        for t in names:
            if node_id is None and t in dataset._tensors:
                n = len(dataset._tensors[t])  # live handle may be unflushed
            else:
                n = dataset.vc.tensor_length(t, node_id)
            if n is None:  # uncovered/legacy node: bind for the count
                n = (len(dataset._tensor(t)) if node_id is None
                     else len(Tensor(t, dataset.vc, node_id=node_id)))
            lengths.append(n)
        return cls(dataset, np.arange(min(lengths, default=0)),
                   node_id=node_id)

    # ------------------------------------------------------------- tensors
    @property
    def tensor_names(self) -> List[str]:
        base = (self._tensor_names if self._tensor_names is not None
                else self.dataset.vc.schema_tensors(self.node_id))
        return base + [d for d in self.derived if d not in base]

    def _base_tensor(self, name: str) -> Tensor:
        if name not in self._bound:
            if self.node_id is None:
                self._bound[name] = self.dataset._tensor(name)
            else:
                self._bound[name] = Tensor(name, self.dataset.vc, node_id=self.node_id)
        return self._bound[name]

    def scan_source(self, name: str):
        """Chunk layout + statistics of one base tensor for planning and
        scheduling (:mod:`repro.core.pipeline`), resolved manifest-first:

        * an already-bound tensor (this view's cache, or the dataset's
          live handle, which may hold unflushed appends) always wins;
        * else a covered node's manifest column-statistics section serves
          the scan index with **zero tensor binds and zero requests**;
        * else the tensor is bound (legacy / stale-node fallback).
        """
        from .pipeline import ManifestScanSource, TensorScanSource
        if name in self._bound:
            return TensorScanSource(self._bound[name])
        if self.node_id is None and name in self.dataset._tensors:
            return TensorScanSource(self.dataset._tensors[name])
        cs = self.dataset.vc.column_stats(name, self.node_id)
        if cs is not None:
            return ManifestScanSource(name, cs)
        return TensorScanSource(self._base_tensor(name))

    def tensor(self, name: str) -> TensorView:
        return TensorView(self._base_tensor(name), self.indices)

    def __getitem__(self, item):
        if isinstance(item, str):
            if item in self.derived:
                return list(self.derived[item])
            return self.tensor(item)
        if isinstance(item, (int, np.integer)):
            return self.row(int(item))
        if isinstance(item, slice):
            sel = np.arange(len(self))[item]
        else:
            sel = np.asarray(item, dtype=np.int64)
        return DatasetView(self.dataset, self.indices[sel], self.node_id,
                           self._tensor_names,
                           {k: [v[i] for i in sel] for k, v in self.derived.items()})

    def __len__(self) -> int:
        return len(self.indices)

    def row(self, i: int, tensors: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        names = list(tensors) if tensors else self.tensor_names
        out: Dict[str, Any] = {}
        for n in names:
            if n in self.derived:
                out[n] = self.derived[n][i]
            else:
                out[n] = self._base_tensor(n).read(int(self.indices[i]))
        return out

    def rows(self) -> List[Dict[str, Any]]:
        return [self.row(i) for i in range(len(self))]

    # --------------------------------------------------------------- persist
    def save(self, view_id: Optional[str] = None) -> str:
        """Persist the view (lineage: 'this run trained on exactly these rows')."""
        vid = view_id or uuid.uuid4().hex[:12]
        node = self.node_id or self.dataset.vc.current_id
        self.dataset.storage.put(
            f"views/{vid}.json",
            json.dumps({"node": node,
                        "indices": self.indices.tolist(),
                        "tensors": self._tensor_names}).encode())
        return vid

    @classmethod
    def load(cls, dataset, view_id: str) -> "DatasetView":
        from .storage import retry_transient
        raw = retry_transient(  # control-plane read: transients retried
            lambda: dataset.storage.get(f"views/{view_id}.json"),
            what=f"views/{view_id}.json")
        d = json.loads(raw.decode())
        return cls(dataset, np.asarray(d["indices"], dtype=np.int64),
                   node_id=d["node"], tensors=d["tensors"])

    # --------------------------------------------------------------- chaining
    def query(self, tql: str, engine: str = "auto", use_stats: bool = True,
              stream: Optional[bool] = None, shards: Optional[int] = None,
              tenant: Optional[str] = None) -> "DatasetView":
        from .tql import execute_query
        return execute_query(self, tql, engine=engine, use_stats=use_stats,
                             stream=stream, shards=shards, tenant=tenant)

    def dataloader(self, **kw):
        from .dataloader import DeepLakeLoader
        return DeepLakeLoader(self, **kw)

    def materialize(self, dest=None, **kw):
        from .materialize import materialize
        return materialize(self, dest, **kw)

    # ------------------------------------------------------------- locality
    def chunk_locality(self, tensor: str) -> float:
        """Fraction of adjacent index pairs living in the same chunk.

        1.0 = perfectly sequential layout; low values = sparse view whose
        streaming will be chunk-inefficient (§4.4 motivation for materialize).
        """
        if len(self.indices) < 2:
            return 1.0
        t = self._base_tensor(tensor)
        same = 0
        prev = t.encoder.chunk_ord_of(int(self.indices[0]))
        for i in self.indices[1:]:
            cur = t.encoder.chunk_ord_of(int(i))
            same += (cur == prev)
            prev = cur
        return same / (len(self.indices) - 1)
