#!/usr/bin/env python3
"""The crop-normalize kernel's times at the image feed's batch, for one
version of the kernel.

Run on a machine with a CUDA card, from the root of a checkout:

    python3 scripts/preprocess_timings.py [--src DIR]

It builds the crop-normalize kernel of the ``repro_torch`` package found
under ``--src`` (default: this checkout's ``src``; another checkout's
``src`` times that version), checks it against its plain version at the
feed's batch, then runs ``chip_smoke.preprocess_timings`` on it: B=256
images of 250 x 250 x 3 uint8, the centre 224 crop, fp32 out; the device ms
with the batch in L2 and over a rotation of batches that L2 cannot hold,
the ms of a call from Python, and the plain version's ms.  It prints the
card's name and power limit, ptxas's registers and spills for the kernel,
and ``[preprocess_timings] {...}``.  Two versions are compared by running
the script for each on one card, in turns.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.kernels.fused_preprocess import ops  # from --src

    if not torch.cuda.is_available():
        raise SystemExit("preprocess_timings: no CUDA device")
    sys.path.insert(1, str(ROOT))
    import chip_smoke   # its repro_torch is the one imported above

    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    ops.build()
    ptxas = chip_smoke._ptxas(ops.library_path().with_suffix(".log")
                              .read_text())
    x = chip_smoke._images((chip_smoke.FEED_BATCH, 250, 250, 3), seed=5)
    args = (chip_smoke.FEED_CROP, chip_smoke.IMAGENET_MEAN,
            chip_smoke.IMAGENET_STD)
    err = (ops.fused_preprocess(x, *args)
           - ops.ref_preprocess(x, *args)).abs().max().item()
    if err > chip_smoke.PRE_ATOL:
        raise AssertionError(f"kernel from {src} off by {err}")
    print("[preprocess_kernel] " + json.dumps(
        {"src": str(src), "ptxas": ptxas, "max_abs_err": err}), flush=True)
    chip_smoke.preprocess_timings(smi)


if __name__ == "__main__":
    main()
