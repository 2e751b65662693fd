"""The learning rates of ``chip_smoke.py``'s ``family`` training phases,
probed on one card: each model's ``FAMILY_JOBS`` job trained at each given
(lr, warmup), from the same lake of Zipf tokens and the same seeded
weights, through ``chip_smoke.train`` with no checkpoint, so that every
gate of a ``[train_*]`` line applies (finite and falling losses, exact
launches, kernel vs torch impls on one batch).

    python3 scripts/lr_probe.py
    python3 scripts/lr_probe.py --archs starcoder2-3b --rates 1e-4:8 1e-5:2

Each run prints its ``[lr_probe]`` line (``chip_smoke.train``'s fields:
``losses``, ``median_step_s``, ``peak_memory_gb``, ...), then a
``[lr_probe_gate]`` line: the arch, lr, warmup, and ``ok`` true or the
failed gate's message.  A run whose losses do not fall goes on to the
next.  The card's name and power limit come before the last line, which
is ``{"ok": ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as c  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*", default=[c.STARCODER2, c.PHI3V])
    ap.add_argument("--rates", nargs="*",
                    default=["1e-4:8", "3e-5:2", "1e-5:2"],
                    help="lr:warmup pairs")
    args = ap.parse_args(argv)
    card = c.environment()
    for arch in args.archs:
        base = c.FAMILY_JOBS[arch]
        lake = c.zipf_lake(base, c.get_arch(arch).vocab_size)
        for pair in args.rates:
            lr, warmup = pair.split(":")
            job = dataclasses.replace(base, lr=float(lr), warmup=int(warmup))
            t0 = time.perf_counter()
            try:
                c.train(card, job, "lr_probe", lake, checkpoint=False)
                ok = True
            except AssertionError as e:   # a gate failed: report, go on
                ok = str(e)[:300]
            c._say("lr_probe_gate", card=card, arch=arch, lr=job.lr,
                   warmup=job.warmup, ok=ok, s=time.perf_counter() - t0)
            c.torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": c.torch.cuda.get_device_name(0),
        "count": c.torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
