"""Checkpointing INTO a Deep Lake dataset (port of
``repro.checkpoint.manager``).

Every save is a *commit* on a Deep Lake dataset whose rows are the flattened
state leaves, under the same ``/``-joined keys, in the same sorted order, with
the same bytes and the same manifest (``dtype`` named as numpy names it,
``bfloat16`` included) as the JAX package writes, so a checkpoint saved by
one package restores in the other.  The leaves are copied to the host when
``save`` is called; the write and the commit run on a background thread.

Restore places each leaf on the device the caller names, or, with
``shardings`` (a tree of DTensor placements) and a ``mesh``, onto that mesh:
rank 0 reads each leaf and scatters its shards, so a state saved by a world
of one size restores on a world of another, or on none (the elastic
restore).  ``save`` gathers a DTensor state whole (``full_tensor``, a
collective every rank joins) and rank 0 alone writes it; the other ranks
keep no record of the step, and ``latest_step(mesh=...)`` answers rank 0's
on every rank.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dataset import Dataset
from repro_torch.core.storage import StorageProvider
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.param import named_leaves, unflatten

_NUMPY_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.int32: "int32",
               torch.int64: "int64", torch.int8: "int8",
               torch.uint8: "uint8", torch.bool: "bool"}


def _host_bytes(t: torch.Tensor) -> Tuple[np.ndarray, str, List[int]]:
    """A leaf as (its bytes as uint8, numpy's name of its dtype, shape).

    The bytes are a private copy, even of a CPU tensor: the train step
    updates the state in place while the background thread writes it.
    """
    if is_dtensor(t):
        raise TypeError("a DTensor leaf is gathered (full_tensor) before it "
                        "is written")
    if t.dtype not in _NUMPY_NAME:
        raise TypeError(f"no checkpoint format for {t.dtype}")
    host = t.detach().to("cpu", copy=True).contiguous()
    raw = host.reshape(-1).view(torch.uint8) if host.numel() else \
        torch.zeros(0, dtype=torch.uint8)
    return raw.numpy(), _NUMPY_NAME[t.dtype], list(t.shape)


def _leaf(raw: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """A leaf from its bytes as the lake reads them: a tiled (large) leaf
    comes back as an array of its own, used as it is; a small one as a
    read-only view of the lake's bytes, copied."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if not raw.flags.writeable:
        raw = raw.copy()
    if dtype == "bfloat16":                 # numpy has no bfloat16
        t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(dtype)))
    return t.reshape(shape).to(device)


class CheckpointManager:
    def __init__(self, storage: StorageProvider | str | None = None, *,
                 keep: int = 3, async_save: bool = True) -> None:
        self.ds = Dataset(storage)
        if "leaves" not in self.ds.tensor_names:
            self.ds.create_tensor("leaves", htype="generic", dtype="uint8",
                                  strict=False, sample_compression="raw",
                                  min_chunk_size=1 << 20, max_chunk_size=8 << 20)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: List[int] = self._scan_steps()

    # ------------------------------------------------------------------ save
    def _scan_steps(self) -> List[int]:
        steps = []
        for node in self.ds.log():
            if node.message and node.message.startswith("step="):
                steps.append(int(node.message.split("=")[1]))
        return sorted(set(steps))

    def save(self, state, step: int, *, blocking: Optional[bool] = None) -> None:
        self.wait()
        if self._error:
            raise self._error
        leaves = list(named_leaves(state))
        writer = not any(is_dtensor(v) for _, v in leaves) or \
            torch.distributed.get_rank() == 0
        host_leaves = []
        for k, v in leaves:             # one leaf whole on the device at once
            v = v.full_tensor() if is_dtensor(v) else v
            if writer:
                host_leaves.append((k, *_host_bytes(v)))
        if not writer:
            return
        if blocking or not self.async_save:
            self._write(host_leaves, step)
        else:
            self._thread = threading.Thread(
                target=self._write_safe, args=(host_leaves, step), daemon=True)
            self._thread.start()

    def _write_safe(self, leaves, step):
        try:
            self._write(leaves, step)
        except BaseException as e:  # surfaced on next save/wait
            self._error = e

    def _write(self, leaves, step: int) -> None:
        t = self.ds["leaves"]
        manifest = []
        base = len(t)
        for i, (key, raw, dtype, shape) in enumerate(leaves):
            t.append(raw)
            manifest.append({"key": key, "dtype": dtype, "shape": shape,
                             "row": base + i})
        self.ds.storage.put(f"manifests/step_{step}.json",
                            json.dumps({"step": step, "leaves": manifest,
                                        "time": time.time()}).encode())
        self.ds.commit(f"step={step}")
        self.saved_steps.append(step)
        self._gc()

    def _gc(self) -> None:
        # retention: drop manifests beyond `keep` (chunks stay version-owned)
        while len(self.saved_steps) > self.keep:
            old = self.saved_steps.pop(0)
            self.ds.storage.delete(f"manifests/step_{old}.json")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest_step(self, mesh=None) -> Optional[int]:
        """The newest saved step; with ``mesh``, rank 0's on every rank."""
        self.wait()
        latest = self.saved_steps[-1] if self.saved_steps else None
        if mesh is None:
            return latest
        box = [latest]
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def restore(self, like, step: Optional[int] = None, device="cpu",
                shardings=None, mesh=None):
        """Rebuild the state tree.  ``like`` gives its structure (a nested
        dict whose leaf paths name the leaves, e.g. of tensors on the meta
        device); every leaf is placed on ``device``.  With ``shardings`` (a
        tree of DTensor placements like ``like``) and ``mesh``, every rank
        calls this: rank 0 reads the leaves and each becomes a DTensor on
        ``mesh``, every rank given its shards."""
        if shardings is None:
            manifest = self._manifest(step)
            return unflatten((key, self._read(manifest, key, device))
                             for key, _ in named_leaves(like))
        from torch.distributed.tensor import distribute_tensor
        step = step if step is not None else self.latest_step(mesh)
        first = torch.distributed.get_rank() == 0
        manifest = self._manifest(step) if first else None
        out = []
        for (key, leaf), (_, placements) in zip(named_leaves(like),
                                                named_leaves(shardings)):
            whole = self._read(manifest, key, device) if first else \
                torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
            out.append((key, distribute_tensor(whole, mesh, placements,
                                               src_data_rank=0)))
        return unflatten(out)

    def _manifest(self, step: Optional[int]) -> Dict[str, dict]:
        """Leaf key -> its row, dtype and shape, of ``step`` (the latest if
        None)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints saved")
        raw = self.ds.storage.get_or_none(f"manifests/step_{step}.json")
        if raw is None:
            raise FileNotFoundError(f"no manifest for step {step}")
        return {m["key"]: m for m in json.loads(raw.decode())["leaves"]}

    def _read(self, manifest: Dict[str, dict], key: str, device
              ) -> torch.Tensor:
        meta = manifest[key]
        return _leaf(self.ds["leaves"].read(meta["row"]), meta["dtype"],
                     meta["shape"], device)
