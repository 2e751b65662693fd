"""Materialization (§4.4): turn a (possibly sparse / linked / derived) view
into a new dataset with stream-optimal chunk layout.

Doing this *late* in the ML workflow minimizes duplication while restoring
sequential chunk locality (``DatasetView.chunk_locality`` ≈ 1.0 after) and
resolving ``link[...]`` indirection, with full lineage: the destination
records the source commit + view indices.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence, Union

import numpy as np

from .dataset import Dataset
from .linked import LinkRegistry, resolve_link
from .storage import StorageProvider
from .views import DatasetView


def materialize(
    view: DatasetView,
    dest: Union[Dataset, StorageProvider, str, None] = None,
    *,
    tensors: Optional[Sequence[str]] = None,
    resolve_links: bool = True,
    registry: Optional[LinkRegistry] = None,
    commit_message: str = "materialize",
) -> Dataset:
    out = dest if isinstance(dest, Dataset) else Dataset(dest)
    names = list(tensors) if tensors else list(view.tensor_names)

    # --- schema -----------------------------------------------------------
    for name in names:
        if name in out.tensor_names:
            continue
        if name in view.derived:
            vals = view.derived[name]
            dtype = str(np.asarray(vals[0]).dtype) if vals else "float32"
            out.create_tensor(name, htype="generic", dtype=dtype,
                              sample_compression="raw")
        else:
            src = view._base_tensor(name)
            meta = src.meta
            htype = meta.htype
            if resolve_links and htype.startswith("link["):
                htype = htype[len("link["):-1]  # materialized data is concrete
                out.create_tensor(name, htype=htype, dtype=None,
                                  sample_compression="raw", strict=False)
            else:
                out.create_tensor(name, htype=htype, dtype=meta.dtype,
                                  sample_compression=meta.codec,
                                  min_chunk_size=meta.min_chunk_size,
                                  max_chunk_size=meta.max_chunk_size,
                                  strict=meta.strict)

    # --- rows, in view order (sequential layout == optimal streaming) ------
    for i in range(len(view)):
        row = {}
        for name in names:
            if name in view.derived:
                row[name] = np.asarray(view.derived[name][i])
            else:
                src = view._base_tensor(name)
                val = src.read(int(view.indices[i]))
                if resolve_links and src.meta.htype.startswith("link["):
                    val = resolve_link(val, registry)
                row[name] = val
        out.append(row)

    # --- lineage ------------------------------------------------------------
    out.storage.put("lineage.json", json.dumps({
        "source_commit": view.node_id or view.dataset.vc.current_id,
        "num_rows": len(view),
        "indices_head": view.indices[:64].tolist(),
        "tensors": names,
    }).encode())
    out.commit(commit_message)
    return out
