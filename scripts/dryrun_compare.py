#!/usr/bin/env python3
"""Two dry runs of every cell side by side: for each (arch x shape x mesh)
cell that both directories hold, the collectives by kind (GB a device),
the collective bound, the dominant term and the peak, old -> new, as a
markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out OLD
    (the same on the other tree) --out NEW
    python3 scripts/dryrun_compare.py OLD NEW [--mesh single|multi]

A cell whose counts did not move is marked "=" and not repeated.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A"}


def _cell(path: Path):
    d = json.loads(path.read_text())
    if d.get("status") != "OK":
        return d.get("status")
    r = d["roofline"]
    return {"kinds": {KINDS[k]: v for k, v in
                      sorted(r["collective_breakdown"].items())},
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "bound_s": r["bound_s"],
            "peak": d["memory_analysis"]["peak_bytes"]}


def _kinds(c) -> str:
    return ", ".join(f"{k} {v / 1e9:.3f}" for k, v in c["kinds"].items())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--mesh", default=None, choices=(None, "single", "multi"))
    args = ap.parse_args()
    print("| cell | collectives GB (old → new) | collective s | dominant | "
          "peak GB |")
    print("|---|---|---|---|---|")
    moved = same = 0
    for path in sorted(args.new.glob("*.json")):
        arch, shape, mesh = path.stem.split("__")[:3]
        if args.mesh and mesh != args.mesh:
            continue
        new, old_path = _cell(path), args.old / path.name
        old = _cell(old_path) if old_path.exists() else None
        if isinstance(new, str) and new.startswith("SKIP"):
            continue
        name = f"{arch} {shape} {mesh}"
        if not isinstance(new, dict) or not isinstance(old, dict):
            print(f"| {name} | {old if not isinstance(old, dict) else 'OK'}"
                  f" → {new if not isinstance(new, dict) else 'OK'} | | | |")
            moved += 1
            continue
        if new["kinds"] == old["kinds"] and new["peak"] == old["peak"]:
            same += 1
            print(f"| {name} | = {_kinds(new)} | = {new['collective_s']:.4g} "
                  f"| = {new['dominant']} | = {new['peak'] / 1e9:.3f} |")
            continue
        moved += 1
        print(f"| {name} | {_kinds(old)} → {_kinds(new)} | "
              f"{old['collective_s']:.4g} → {new['collective_s']:.4g} | "
              f"{old['dominant']} → {new['dominant']} | "
              f"{old['peak'] / 1e9:.3f} → {new['peak'] / 1e9:.3f} |")
    print(f"\n{moved} cells moved, {same} did not.")


if __name__ == "__main__":
    main()
