"""Deep Lake -> PyTorch training integration (port of ``repro.data.pipeline``).

``TokenBatcher`` packs ragged documents from a Deep Lake view into fixed
(B, S+1) token blocks (targets = inputs shifted), as in the JAX package.
``DeviceFeeder`` turns a host batch iterator into tensors on the device with
DOUBLE BUFFERING: a producer thread copies each batch into pinned host memory
and issues its host-to-device copy ``non_blocking`` on a side CUDA stream,
so the next batch's copy overlaps the current train step; the consumer's
stream waits on that copy's event before it uses the batch.  On the CPU a
batch is ``torch.from_numpy``, nothing more.

Under a mesh (``placements``: DTensor placements per key, as JAX's
``shardings``), every rank builds the same global batch from the lake (same
seed, same order), copies only its own slice to the device and wraps it with
``DTensor.from_local``: nothing is sent between ranks.

Multi-host note: each host feeds only its slice of the global batch
(``host_slice``); in one process that slice is the whole batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.dataloader import DeepLakeLoader
from repro_torch.core.views import DatasetView


class TokenBatcher:
    """Streams (tokens, targets, loss_mask) host batches from a token view."""

    def __init__(self, view: DatasetView, *, batch_size: int, seq_len: int,
                 shuffle: bool = True, num_workers: int = 4, seed: int = 0,
                 pad_id: int = 0, num_codebooks: int = 0) -> None:
        self.view = view
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_codebooks = num_codebooks
        self.pad_id = pad_id
        self.loader = DeepLakeLoader(view, batch_size=1, shuffle=shuffle,
                                     num_workers=num_workers, seed=seed,
                                     tensors=["tokens"], collate="list")
        self._buf = np.zeros((0,), np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        B, S = self.batch_size, self.seq_len
        need = B * (S + 1)
        self._buf = np.zeros((0,), np.int32)
        for batch in self.loader:
            doc = np.asarray(batch["tokens"][0], np.int32).reshape(-1)
            self._buf = np.concatenate([self._buf, doc])
            while len(self._buf) >= need:
                block = self._buf[:need].reshape(B, S + 1)
                self._buf = self._buf[need:]
                out = {"tokens": block[:, :-1],
                       "targets": block[:, 1:],
                       "loss_mask": np.ones((B, S), np.float32)}
                if self.num_codebooks:
                    k = self.num_codebooks
                    out["tokens"] = np.stack([block[:, :-1]] * k, axis=1)
                    out["targets"] = np.stack([block[:, 1:]] * k, axis=1)
                yield out


class DeviceFeeder:
    """Double-buffered host->device feeder.

    Yields dicts of tensors on ``device``, in the host iterator's order and
    with its dtypes.  At most ``prefetch`` batches are on their way at once.
    """

    def __init__(self, host_iter: Iterator[Dict[str, np.ndarray]],
                 device, *, prefetch: int = 2, placements=None,
                 mesh=None) -> None:
        if (placements is None) != (mesh is None):
            raise ValueError("placements and mesh go together")
        self.host_iter = host_iter
        self.device = torch.device(device)
        self.prefetch = max(1, prefetch)
        self.placements = placements or {}
        self.mesh = mesh

    def _local(self, batch):
        """Each array's slice on this rank (the whole array for a key with no
        placements)."""
        if self.mesh is None:
            return batch
        return {k: local_slice(v, self.placements[k], self.mesh)
                if k in self.placements else v for k, v in batch.items()}

    def _wrap(self, out):
        if self.mesh is None:
            return out
        from torch.distributed.tensor import DTensor, Replicate
        rep = [Replicate()] * self.mesh.ndim
        return {k: DTensor.from_local(v, self.mesh,
                                      self.placements.get(k, rep),
                                      run_check=False)
                for k, v in out.items()}

    def _put_cpu(self, batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self._local(batch).items()}

    def _put_cuda(self, batch, stream: torch.cuda.Stream):
        """Pinned copies, sent on ``stream``; returns (tensors, event)."""
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in self._local(batch).items()}
        with torch.cuda.stream(stream):
            out = {k: v.to(self.device, non_blocking=True)
                   for k, v in pinned.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        cuda = self.device.type == "cuda"
        if not cuda and self.device.type != "cpu":
            raise ValueError(f"no feeder for device {self.device}")
        device = self.device
        if cuda and device.index is None:   # the producer thread names it
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        DONE = object()
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            """``item`` to the consumer; False once the consumer has gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(device)
                for batch in self.host_iter:
                    if not put(self._put_cuda(batch, stream) if cuda
                               else (self._put_cpu(batch), None)):
                        return
            except BaseException as e:
                err.append(e)
            finally:
                close = getattr(self.host_iter, "close", None)
                if stop.is_set() and close is not None:
                    close()         # the host iterator's threads stop too
                put(DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    if err:
                        raise err[0]
                    return
                out, done = item
                if done is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(done)
                    for v in out.values():
                        # memory made on the side stream, used on the
                        # consumer's
                        v.record_stream(consumer)
                yield self._wrap(out)
        finally:
            # a consumer that stops early (the iterator closed or dropped)
            # lets the producer go: blocked on a full queue, it would hold
            # the host iterator, and all that refers to, for ever; and waits
            # for it, so that no thread of the feeder's is still in a torch
            # call when the process exits
            stop.set()
            t.join(timeout=60)


def local_slice(a: np.ndarray, placements, mesh) -> np.ndarray:
    """This rank's piece of ``a`` under DTensor ``placements`` on ``mesh``:
    each ``Shard(d)`` mesh dim, in mesh order, splits dim ``d`` into equal
    parts and keeps the one at this rank's coordinate (the split DTensor
    makes, nested left to right)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if a.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {a.shape} does not split "
                                 f"into {n}")
            per = a.shape[p.dim] // n
            a = np.take(a, range(coord[i] * per, (coord[i] + 1) * per),
                        axis=p.dim)
    return a


def host_slice(batch: Dict[str, np.ndarray], process_index: int,
               process_count: int) -> Dict[str, np.ndarray]:
    """Each host contributes its contiguous slice of the global batch."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // process_count
        out[k] = v[process_index * per:(process_index + 1) * per]
    return out
