#!/usr/bin/env python3
"""Where one decode-attention call spends its time on the host.

Run on a machine with a CUDA card, from the root of a checkout:

    python3 scripts/decode_call_profile.py [--src DIR] [--calls N]

It builds the decode-attention kernel of the ``repro_torch`` package found
under ``--src`` (default: this checkout's ``src``; another checkout's
``src`` profiles that version), then, at gemma-2b's served shape (B=4, H=8,
Hkv=1, D=256, a 64-entry bf16 cache at pos 63):

* ``call_ms``: CUDA events around ``--calls`` calls issued from Python, as
  the serving loop issues them, over the count;
* ``device_ms``: the same calls captured in a CUDA graph and replayed, so
  that the host's time is not counted;
* the host profile: ``cProfile`` over ``--calls`` calls, the functions with
  the most time of their own, in µs a call.

It prints one JSON line, ``[decode_call_profile] {...}``.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[1] / "src")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))

    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import decode_attention, ops

    if not torch.cuda.is_available():
        raise SystemExit("decode_call_profile: no CUDA device")
    ops.build()
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to("cuda", torch.bfloat16)
               for shape in ((4, 8, 256), (4, 64, 1, 256), (4, 64, 1, 256)))

    def call():
        return decode_attention(q, k, v, pos=63)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.calls):
        call()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / args.calls

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / 200

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.calls):
        call()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = []
    for (file, line, name), (_, ncalls, tottime, cumtime, _) in \
            stats.stats.items():
        rows.append({"function": f"{Path(file).name}:{line}({name})",
                     "calls_per_call": ncalls / args.calls,
                     "own_us_per_call": tottime / args.calls * 1e6,
                     "cum_us_per_call": cumtime / args.calls * 1e6})
    rows.sort(key=lambda r: -r["own_us_per_call"])
    total_us = sum(r["own_us_per_call"] for r in rows)
    print("[decode_call_profile] " + json.dumps({
        "src": str(args.src), "device": torch.cuda.get_device_name(0),
        "call_ms": call_ms, "device_ms": device_ms,
        "profiled_us_per_call": total_us, "top": rows[:args.top]}),
        flush=True)


if __name__ == "__main__":
    main()
