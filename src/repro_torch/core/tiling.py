"""Tiling of over-sized samples (§3.4).

If a single encoded sample exceeds the max chunk size (large aerial /
microscopy images), the sample is split into a grid of tiles across its
spatial dimensions; each tile becomes its own chunk.  The sample's slot in
the parent chunk then holds a JSON *tile descriptor* (FLAG_TILED) instead of
payload bytes.  Partial reads (TQL crops, §3.5 range access) fetch only the
intersecting tiles.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .codecs import get_codec


@dataclass
class TileDescriptor:
    sample_shape: Tuple[int, ...]
    tile_shape: Tuple[int, ...]
    grid_shape: Tuple[int, ...]
    chunk_names: List[str]          # row-major over the grid
    dtype: str
    codec: str

    def to_bytes(self) -> bytes:
        return json.dumps({
            "sample_shape": self.sample_shape, "tile_shape": self.tile_shape,
            "grid_shape": self.grid_shape, "chunk_names": self.chunk_names,
            "dtype": self.dtype, "codec": self.codec,
        }).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "TileDescriptor":
        d = json.loads(data.decode())
        return cls(tuple(d["sample_shape"]), tuple(d["tile_shape"]),
                   tuple(d["grid_shape"]), list(d["chunk_names"]),
                   d["dtype"], d["codec"])

    def num_tiles(self) -> int:
        return int(np.prod(self.grid_shape)) if self.grid_shape else 1

    def tile_slices(self, flat_idx: int) -> Tuple[slice, ...]:
        coords = np.unravel_index(flat_idx, self.grid_shape)
        return tuple(
            slice(c * t, min((c + 1) * t, s))
            for c, t, s in zip(coords, self.tile_shape, self.sample_shape))


def plan_tile_shape(shape: Sequence[int], itemsize: int, max_bytes: int) -> Tuple[int, ...]:
    """Choose a tile shape whose raw size fits ``max_bytes``.

    Halve the largest dims first (keeps tiles near-square across spatial
    dims — good locality for crops), until the tile fits.
    """
    tile = [max(1, int(s)) for s in shape]
    budget = max(1, max_bytes)
    while int(np.prod(tile)) * itemsize > budget:
        j = int(np.argmax(tile))
        if tile[j] == 1:
            break
        tile[j] = (tile[j] + 1) // 2
    return tuple(tile)


def split_into_tiles(arr: np.ndarray, tile_shape: Sequence[int]) -> Tuple[Tuple[int, ...], List[np.ndarray]]:
    grid = tuple(math.ceil(s / t) for s, t in zip(arr.shape, tile_shape))
    tiles: List[np.ndarray] = []
    for flat in range(int(np.prod(grid)) if grid else 1):
        coords = np.unravel_index(flat, grid) if grid else ()
        sl = tuple(slice(c * t, min((c + 1) * t, s))
                   for c, t, s in zip(coords, tile_shape, arr.shape))
        tiles.append(np.ascontiguousarray(arr[sl]))
    return grid, tiles


def assemble_from_tiles(desc: TileDescriptor, tile_payloads: Sequence[bytes]) -> np.ndarray:
    """Full-sample reassembly from per-tile codec payloads (row-major)."""
    codec = get_codec(desc.codec)
    out = np.zeros(desc.sample_shape, dtype=np.dtype(desc.dtype))
    for flat, payload in enumerate(tile_payloads):
        sl = desc.tile_slices(flat)
        tshape = tuple(s.stop - s.start for s in sl)
        out[sl] = codec.decode(payload, tshape, np.dtype(desc.dtype))
    return out


def tiles_for_region(desc: TileDescriptor, region: Sequence[slice]) -> List[int]:
    """Flat tile indices intersecting ``region`` (per-dim slices, step=1)."""
    lo = []
    hi = []
    for d, (t, s) in enumerate(zip(desc.tile_shape, desc.sample_shape)):
        sl = region[d] if d < len(region) else slice(None)
        start, stop, step = sl.indices(s)
        if step != 1:
            # conservative: cover the full extent for strided access
            start, stop = min(start, stop), max(start, stop)
        if stop <= start:
            return []
        lo.append(start // t)
        hi.append((stop - 1) // t)
    idxs: List[int] = []
    ranges = [range(a, b + 1) for a, b in zip(lo, hi)]

    def rec(dim: int, coords: List[int]) -> None:
        if dim == len(ranges):
            idxs.append(int(np.ravel_multi_index(coords, desc.grid_shape)))
            return
        for c in ranges[dim]:
            rec(dim + 1, coords + [c])

    rec(0, [])
    return idxs


def assemble_region(desc: TileDescriptor, region: Sequence[slice],
                    tile_payloads: dict) -> np.ndarray:
    """Assemble only ``region`` from the given {flat_tile_idx: payload} map."""
    codec = get_codec(desc.codec)
    starts = [region[d].indices(s)[0] if d < len(region) else 0
              for d, s in enumerate(desc.sample_shape)]
    stops = [region[d].indices(s)[1] if d < len(region) else s
             for d, s in enumerate(desc.sample_shape)]
    out_shape = tuple(max(0, b - a) for a, b in zip(starts, stops))
    out = np.zeros(out_shape, dtype=np.dtype(desc.dtype))
    for flat, payload in tile_payloads.items():
        tsl = desc.tile_slices(flat)
        tshape = tuple(s.stop - s.start for s in tsl)
        tile = codec.decode(payload, tshape, np.dtype(desc.dtype))
        src = []
        dst = []
        for d in range(len(out_shape)):
            a = max(starts[d], tsl[d].start)
            b = min(stops[d], tsl[d].stop)
            if b <= a:
                break
            src.append(slice(a - tsl[d].start, b - tsl[d].start))
            dst.append(slice(a - starts[d], b - starts[d]))
        else:
            out[tuple(dst)] = tile[tuple(src)]
    return out
