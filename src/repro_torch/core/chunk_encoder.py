"""Chunk encoder: the compressed index map of §3.4.

Maps a global sample index to ``(chunk name, local index within chunk)``.
Representation is one row per chunk, ``last_global_index`` ascending, so
lookup is ``O(log n_chunks)`` bisect and the whole structure stays tiny:
~16 bytes + name per chunk ⇒ the paper's "150MB encoder per 1PB of data"
scale is matched (16MB chunks ⇒ 62.5M chunks/PB ⇒ ~24B each ≈ 1.5GB naive,
or ~150MB once zlib'd names are amortized — we store names in a deduplicated
table and compress on serialize).

The encoder is copy-on-write friendly: ``replace()`` swaps a chunk's name
in-place (used when an in-place sample update rewrites a chunk under version
control) without disturbing index ranges.

:class:`ChunkStatsTable` is the encoder's statistics sidecar: chunk name ->
:class:`~repro.core.chunks.ChunkStats`, persisted per tensor per version as
``chunk_stats.json`` and consumed by the TQL scan planner for data skipping.
Both structures key by chunk *name*, so they survive commits unchanged while
chunk payloads stay where they were created (§4.1).
"""

from __future__ import annotations

import json
import zlib
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .chunks import ChunkStats


def ords_of_boundaries(last_idx: Union[Sequence[int], np.ndarray],
                       global_indices: Union[Sequence[int], np.ndarray]
                       ) -> np.ndarray:
    """Vectorized global-index -> chunk-ord map over a chunk boundary
    table (``last_idx`` = inclusive last global sample index per chunk,
    ascending).  The single implementation behind
    :meth:`ChunkEncoder.ords_of` and the manifest's
    :meth:`~repro.core.manifest.ColumnStats.ords_of`, so planner verdicts
    are identical whichever source serves the scan index."""
    arr = np.asarray(global_indices, dtype=np.int64)
    bounds = np.asarray(last_idx, dtype=np.int64)
    n = int(bounds[-1]) + 1 if len(bounds) else 0
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= n):
        raise IndexError(f"indices out of range [0, {n})")
    return np.searchsorted(bounds, arr, side="left")


class ChunkEncoder:
    def __init__(self) -> None:
        self._last_idx: List[int] = []   # inclusive last global sample idx per chunk
        self._names: List[str] = []

    # -- writes --------------------------------------------------------------
    def register_chunk(self, name: str, num_samples: int) -> None:
        if num_samples <= 0:
            raise ValueError("chunk must contain at least one sample")
        last = (self._last_idx[-1] if self._last_idx else -1) + num_samples
        self._last_idx.append(last)
        self._names.append(name)

    def extend_last(self, extra_samples: int) -> None:
        """Grow the open (final) chunk by ``extra_samples``."""
        if not self._last_idx:
            raise ValueError("no chunk registered")
        self._last_idx[-1] += extra_samples

    def replace(self, chunk_ord: int, new_name: str) -> None:
        self._names[chunk_ord] = new_name

    def pop_last(self) -> str:
        self._last_idx.pop()
        return self._names.pop()

    # -- reads ---------------------------------------------------------------
    @property
    def num_samples(self) -> int:
        return (self._last_idx[-1] + 1) if self._last_idx else 0

    @property
    def num_chunks(self) -> int:
        return len(self._names)

    def chunk_names(self) -> List[str]:
        return list(self._names)

    def chunk_ord_of(self, global_idx: int) -> int:
        n = self.num_samples
        if not 0 <= global_idx < n:
            raise IndexError(f"sample {global_idx} out of range [0, {n})")
        return bisect_left(self._last_idx, global_idx)

    def ords_of(self, global_indices: Union[Sequence[int], np.ndarray]) -> np.ndarray:
        """Vectorized ``chunk_ord_of`` over an index array (scan planning)."""
        return ords_of_boundaries(self._last_idx, global_indices)

    def lookup(self, global_idx: int) -> Tuple[str, int]:
        """global index -> (chunk name, local index inside that chunk)."""
        ord_ = self.chunk_ord_of(global_idx)
        first = (self._last_idx[ord_ - 1] + 1) if ord_ else 0
        return self._names[ord_], global_idx - first

    def chunk_span(self, chunk_ord: int) -> Tuple[int, int]:
        """[first, last] inclusive global index range of chunk ``chunk_ord``."""
        first = (self._last_idx[chunk_ord - 1] + 1) if chunk_ord else 0
        return first, self._last_idx[chunk_ord]

    def name_of(self, chunk_ord: int) -> str:
        return self._names[chunk_ord]

    def samples_in(self, chunk_ord: int) -> int:
        first, last = self.chunk_span(chunk_ord)
        return last - first + 1

    # -- wire -----------------------------------------------------------------
    def serialize(self) -> bytes:
        idx = np.asarray(self._last_idx, dtype="<u8").tobytes()
        names = json.dumps(self._names).encode()
        blob = (len(idx)).to_bytes(8, "little") + idx + names
        return zlib.compress(blob, 1)

    @classmethod
    def deserialize(cls, data: bytes) -> "ChunkEncoder":
        blob = zlib.decompress(data)
        nidx = int.from_bytes(blob[:8], "little")
        enc = cls()
        enc._last_idx = [int(x) for x in np.frombuffer(blob[8:8 + nidx], dtype="<u8")]
        enc._names = json.loads(blob[8 + nidx:].decode())
        return enc

    def copy(self) -> "ChunkEncoder":
        c = ChunkEncoder()
        c._last_idx = list(self._last_idx)
        c._names = list(self._names)
        return c

    def nbytes(self) -> int:
        return 8 * len(self._last_idx) + sum(len(n) for n in self._names)


class ChunkStatsTable:
    """chunk name -> :class:`ChunkStats`; the ``chunk_stats.json`` sidecar.

    Missing entries are legal (pre-stats datasets, ancestor chunks written
    before the sidecar existed): the planner treats them as unknown and keeps
    the chunk, so the table is purely an optimization, never a correctness
    requirement.
    """

    def __init__(self) -> None:
        self._by_name: Dict[str, ChunkStats] = {}

    def set(self, chunk_name: str, stats: ChunkStats) -> None:
        self._by_name[chunk_name] = stats

    def get(self, chunk_name: str) -> Optional[ChunkStats]:
        return self._by_name.get(chunk_name)

    def drop(self, chunk_name: str) -> None:
        self._by_name.pop(chunk_name, None)

    def prune_to(self, live_names: Sequence[str]) -> None:
        """Keep only entries for chunks the encoder still references."""
        live = set(live_names)
        for name in [n for n in self._by_name if n not in live]:
            del self._by_name[name]

    def __len__(self) -> int:
        return len(self._by_name)

    def __contains__(self, chunk_name: str) -> bool:
        return chunk_name in self._by_name

    # -- wire -----------------------------------------------------------------
    def serialize(self) -> bytes:
        return json.dumps(
            {"chunks": {k: v.to_json() for k, v in self._by_name.items()}}
        ).encode()

    @classmethod
    def deserialize(cls, data: bytes) -> "ChunkStatsTable":
        table = cls()
        d = json.loads(data.decode())
        for name, sj in d.get("chunks", {}).items():
            table._by_name[name] = ChunkStats.from_json(sj)
        return table
