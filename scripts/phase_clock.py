"""The one-card phases of ``chip_smoke.py`` whose clock grew, timed for
several trees in turn on one card: gemma-2b's training with its checkpoint
save and restore (``train``), mamba2-1.3b's at its ``TRAIN_CUT`` depth
(``train_mamba2``), granite-moe-1b-a400m's at its (``train_granite``) and
mamba2-1.3b's serve phase (``serve_mamba2``), each called as
``chip_smoke.main`` calls it.

    python3 scripts/phase_clock.py --roots build/old,.
    python3 scripts/phase_clock.py --roots build/old,. --phases train,train_mamba2

A tree is a checkout of the repository (``git archive`` of a commit
unpacked into a directory that ``.gitignore`` lists); each runs in a process
of its own with its own ``src/`` and ``chip_smoke.py``, which builds its
kernels.  Each phase prints its own lines; then, for each tree, one line
``[phase_clock] {...}``: per phase its wall s around the call (a training
phase's lake included, as the script's clock counts it), and from its own
line the checkpoint's ``save_s`` and ``restore_s`` and the median
``step_s``.  The card's name and power limit come before the last line,
which is ``{"ok": ...}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# each phase, and the tag of the line it prints
PHASES = {"train": "train", "train_mamba2": "train_mamba2",
          "train_granite": "train_granite", "serve_mamba2": "serve"}
RUN_TIMEOUT_S = 900                   # a tree's phases, its kernels' build


def role_tree(root: Path, phases) -> None:
    """One tree's phases, in this process, on card 0."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as c
    from repro_torch.configs import get_arch
    said = {}
    real_say = c._say

    def say(tag, **fields):
        said[tag] = fields
        real_say(tag, **fields)
    c._say = say
    card = c.environment()

    def trained(job, tag):
        lake = c.zipf_lake(job, get_arch(job.arch).vocab_size)
        c.train(card, job, tag, lake, c.TRAIN_CUT[job.arch])
    run = {"train": lambda: c.train(card),
           "train_mamba2": lambda: trained(c.MAMBA2_JOB, "train_mamba2"),
           "train_granite": lambda: trained(c.GRANITE_JOB, "train_granite"),
           "serve_mamba2": lambda: c.serve(card, "mamba2-1.3b")}
    line = {"root": str(root), "card": card}
    for phase in phases:
        t0 = time.perf_counter()
        run[phase]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = said.get(PHASES[phase], {})
        line[phase] = {"wall_s": wall, **{k: got[k] for k in (
            "save_s", "restore_s", "median_step_s") if k in got}}
        torch.cuda.empty_cache()
    print("[phase_clock] " + json.dumps(line), flush=True)


def lead(roots, phases) -> int:
    ok = True
    for root in roots:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--role",
               "tree", "--root",
               str(Path(root).resolve()), "--phases", ",".join(phases)]
        try:
            rc = subprocess.run(cmd, cwd=root, timeout=RUN_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = 124
        ok &= rc == 0
        print("[phase_clock_run] " + json.dumps({"root": root, "rc": rc}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "no nvidia-smi")
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", default=".", help="the trees, in order")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"some of {', '.join(PHASES)}")
    ap.add_argument("--role", choices=("lead", "tree"), default="lead")
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    phases = tuple(args.phases.split(","))
    if any(p not in PHASES for p in phases):
        ap.error(f"--phases: each of {', '.join(PHASES)}")
    if args.role == "tree":
        role_tree(Path(args.root), phases)
        return 0
    return lead(args.roots.split(","), phases)


if __name__ == "__main__":
    sys.exit(main())
