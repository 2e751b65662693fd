"""End to end on the PyTorch port: train an LM on token data streamed
from Deep Lake, on the CUDA device (``--device cpu`` for the CPU).

Default preset is small; ``--preset 100m`` builds a ~100M-parameter model
(the deliverable's end-to-end shape) through the port's ``build_model`` and
``make_train_step``.

    PYTHONPATH=src python examples/torch_train_lm.py                # tiny
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 8
"""

import argparse

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import Trainer, TrainJob
from repro_torch.models import build_model, count_params

# ~100M params: gemma-family, 12L x d=768 x ff=3072, 16k vocab
OVERRIDE_100M = dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                     head_dim=64, d_ff=3072, vocab_size=16384,
                     dtype="float32")


def build_job(preset: str, steps: int, remote: bool, device=None) -> TrainJob:
    if preset == "tiny":
        return TrainJob(arch="gemma-2b", smoke=True, steps=steps,
                        global_batch=8, seq_len=128, remote_data=remote,
                        checkpoint_every=max(steps // 3, 1), num_docs=64,
                        device=device)
    if preset == "100m":
        return TrainJob(arch="gemma-2b", smoke=True, steps=steps,
                        global_batch=16, seq_len=512, remote_data=remote,
                        checkpoint_every=50, num_docs=512, lr=6e-4,
                        device=device)
    raise SystemExit(f"unknown preset {preset}")


def use_config(trainer: Trainer, cfg) -> None:
    """Rebuild the trainer's model, step and token lake for ``cfg``."""
    trainer.cfg = cfg
    trainer.model = build_model(cfg, shard_fn=trainer.model.shard)
    trainer.step_fn = make_train_step(trainer.model, trainer.opt)
    trainer.data_ds = trainer._make_data()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--remote", action="store_true",
                    help="stream through the simulated S3 provider")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args(argv)
    trainer = Trainer(build_job(args.preset, args.steps, args.remote,
                                args.device))
    if args.preset == "100m":
        use_config(trainer, reduce_for_smoke(get_arch("gemma-2b")).with_(
            **OVERRIDE_100M))
        print(f"100m preset: "
              f"{count_params(trainer.model.param_specs())/1e6:.0f}M params")
    out = trainer.run(restore=False)
    print(f"\nfinal step {out['final_step']}  loss {out['final_loss']:.4f}  "
          f"(started at {out['history'][0]['loss']:.4f})")
    return out


if __name__ == "__main__":
    main()
