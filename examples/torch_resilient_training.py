"""Fault tolerance on the PyTorch port: a training run that survives two
injected host failures by restoring from async checkpoints (stored as Deep
Lake commits), with straggler detection active.  Trains on the CUDA device
(``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/torch_resilient_training.py
    PYTHONPATH=src python examples/torch_resilient_training.py --device cpu --steps 8
"""

import argparse
import dataclasses

import repro_torch.core as dl
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import run_resilient
from repro_torch.launch.train import Trainer, TrainJob


def make_job(steps: int, device=None) -> TrainJob:
    """24 steps fail at 7 and 15 and checkpoint every 4; fewer, at the same
    shares of the run."""
    return TrainJob(arch="starcoder2-3b", smoke=True, steps=steps,
                    global_batch=4, seq_len=64,
                    checkpoint_every=max(steps // 6, 1), num_docs=32,
                    fail_at=(steps * 7 // 24, steps * 15 // 24),
                    log_every=4, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args(argv)
    job = make_job(args.steps, args.device)
    ckpt = CheckpointManager(dl.MemoryProvider(), keep=3)
    shared = {}

    def make_runner(_):
        def run():
            # after the first crash the transient fault is gone (new 'host')
            remaining = tuple(s for s in job.fail_at
                              if s not in shared.get("fired", set()))
            j = dataclasses.replace(job, fail_at=remaining)
            t = Trainer(j, ckpt=ckpt, data_ds=shared.get("data"))
            shared["data"] = t.data_ds
            try:
                out = t.run(restore=True)
            finally:
                shared.setdefault("fired", set()).update(t.injector.seen)
            shared["out"] = out
            return out["final_step"]
        return run

    result = run_resilient(
        make_runner, max_restarts=4,
        on_restart=lambda n, e: print(f"--- restart #{n} after: {e}"))
    print(f"\nsurvived {result['restarts']} failures; "
          f"final step {result['final_step']}, "
          f"loss {shared['out']['final_loss']:.4f}")
    print(f"checkpoint history (Deep Lake commits): "
          f"{[n.message for n in ckpt.ds.log()][:6]}")
    return dict(result, out=shared["out"], ckpt=ckpt)


if __name__ == "__main__":
    main()
