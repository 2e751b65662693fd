"""Training driver: Deep Lake streaming -> train loop on the card, with
checkpoint/restart into the lake, straggler detection and failure injection
(port of ``repro.launch.train``).

The trainer runs on the card unless the caller names another device; with no
CUDA device present and none named, it raises.  Attention goes through the
hand-written flash-attention kernel on the card.

CLI:
    python -m repro_torch.launch.train --arch gemma-2b --steps 20
    python -m repro_torch.launch.train --device cpu --steps 20 \\
        --grad-compress --fail-at 12 --checkpoint-every 5
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.core.dataset import Dataset
from repro_torch.core.storage import MemoryProvider, SimulatedS3Provider, chain
from repro_torch.core.views import DatasetView
from repro_torch.data import DeviceFeeder, TokenBatcher, build_token_dataset
from repro_torch.distributed import (FailureInjector, StragglerDetector,
                                     run_resilient)
from repro_torch.launch.steps import (init_state, make_train_step,
                                      train_state_specs)
from repro_torch.models.model import build_model
from repro_torch.models.param import abstract
from repro_torch.optim import AdamW, cosine_schedule


@dataclass
class TrainJob:
    arch: str = "gemma-2b"
    smoke: bool = True              # reduced config (CPU scale)
    steps: int = 20
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup: int = 10
    microbatches: int = 1
    grad_compress: bool = False
    checkpoint_every: int = 10
    keep_checkpoints: int = 3
    remote_data: bool = False       # stream through the SimulatedS3 provider
    shuffle: bool = True
    num_docs: int = 64
    tql_filter: Optional[str] = None
    fail_at: tuple = ()
    seed: int = 0
    model_axis: int = 1
    log_every: int = 5
    device: Optional[str] = None    # None: the CUDA device


class Trainer:
    def __init__(self, job: TrainJob, *, data_ds: Optional[Dataset] = None,
                 ckpt: Optional[CheckpointManager] = None) -> None:
        if job.model_axis > 1:
            raise NotImplementedError(
                "tensor-parallel training is not ported yet; see ROADMAP "
                "Queue 1 item 16 (distribution)")
        if job.device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        self.job = job
        self.device = torch.device(job.device or "cuda")
        cfg = get_arch(job.arch)
        if job.smoke:
            cfg = reduce_for_smoke(cfg)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.opt = AdamW(cosine_schedule(job.lr, job.warmup, max(job.steps, 2)),
                         moment_dtype=cfg.adam_moment_dtype)
        self.step_fn = make_train_step(self.model, self.opt,
                                       microbatches=job.microbatches,
                                       grad_compress=job.grad_compress)
        self.ckpt = ckpt or CheckpointManager(MemoryProvider(),
                                              keep=job.keep_checkpoints)
        self.data_ds = data_ds or self._make_data()
        self.straggler = StragglerDetector(
            on_straggler=lambda s, t, base: print(
                f"[straggler] step {s}: {t*1e3:.0f}ms vs baseline "
                f"{base*1e3:.0f}ms -> rebuilding input pipeline"))
        self.injector = FailureInjector(fail_at_steps=tuple(job.fail_at))
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ data
    def _make_data(self) -> Dataset:
        if self.job.remote_data:
            store = chain(MemoryProvider(),
                          SimulatedS3Provider(time_scale=0.02),
                          capacity_bytes=64 << 20)
        else:
            store = MemoryProvider()
        ds = Dataset(store)
        build_token_dataset(ds, num_docs=self.job.num_docs,
                            doc_len=self.job.seq_len * 4,
                            vocab_size=self.cfg.vocab_size, seed=self.job.seed)
        return ds

    def _batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        view = (self.data_ds.query(self.job.tql_filter)
                if self.job.tql_filter else DatasetView.full(self.data_ds))
        batcher = TokenBatcher(view, batch_size=self.job.global_batch,
                               seq_len=self.job.seq_len,
                               shuffle=self.job.shuffle, seed=self.job.seed,
                               num_codebooks=self.cfg.num_codebooks)

        def with_extras():
            rng = np.random.default_rng(self.job.seed)
            for b in batcher:
                if self.cfg.num_image_tokens:
                    b["image_embeds"] = rng.standard_normal(
                        (self.job.global_batch, self.cfg.num_image_tokens,
                         1024)).astype(np.float32)
                yield b

        return iter(DeviceFeeder(with_extras(), self.device))

    # ------------------------------------------------------------------ run
    def run(self, *, restore: bool = True) -> Dict[str, Any]:
        job = self.job
        start_step = 0
        if restore and self.ckpt.latest_step() is not None:
            specs = train_state_specs(self.model, self.opt,
                                      grad_compress=job.grad_compress)
            state = self.ckpt.restore(abstract(specs), device=self.device)
            start_step = self.ckpt.latest_step()
            print(f"[restore] resumed from step {start_step}")
        else:
            gen = torch.Generator(self.device).manual_seed(job.seed)
            state = init_state(self.model, self.opt, gen, self.device,
                               grad_compress=job.grad_compress)
        batches = self._batches()
        step = start_step
        while step < job.steps:
            try:
                batch = next(batches)
            except StopIteration:
                batches = self._batches()  # next epoch
                continue
            t0 = time.perf_counter()
            self.injector.check(step)
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.straggler.observe(step, dt):
                batches = self._batches()  # mitigation: rebuild pipeline
            self.history.append({"step": step, "loss": loss, "sec": dt})
            if step % job.log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"({dt*1e3:6.0f} ms)")
            step += 1
            if step % job.checkpoint_every == 0 or step == job.steps:
                self.ckpt.save(state, step)
        self.ckpt.wait()
        return {"state": state, "final_step": step,
                "final_loss": self.history[-1]["loss"] if self.history else None,
                "history": self.history}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--remote-data", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--tql", default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args()
    job = TrainJob(arch=args.arch, smoke=args.smoke, steps=args.steps,
                   global_batch=args.global_batch, seq_len=args.seq_len,
                   microbatches=args.microbatches,
                   grad_compress=args.grad_compress,
                   remote_data=args.remote_data,
                   checkpoint_every=args.checkpoint_every,
                   fail_at=tuple(args.fail_at), tql_filter=args.tql,
                   model_axis=args.model_axis, device=args.device)

    ckpt = CheckpointManager(MemoryProvider(), keep=3)
    trainer_box = {}

    def make_runner(_restore_step):
        def run():
            t = Trainer(job, ckpt=ckpt, data_ds=trainer_box.get("data"))
            trainer_box["data"] = t.data_ds
            out = t.run()
            trainer_box["out"] = out
            return out["final_step"]
        return run

    result = run_resilient(make_runner, max_restarts=3,
                           on_restart=lambda n, e: print(f"[restart {n}] {e}"))
    print(f"done: final_step={result['final_step']} "
          f"restarts={result['restarts']} "
          f"final_loss={trainer_box['out']['final_loss']:.4f}")


if __name__ == "__main__":
    main()
