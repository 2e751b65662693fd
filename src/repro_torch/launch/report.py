"""Render the dry run's tables from ``experiments/dryrun_torch/*.json`` (port
of ``repro.launch.report``, with its columns; ``trace`` in place of
``compile``).  Every number in them is a dry-run count on H100 figures, not
a measurement.

Usage: python -m repro_torch.launch.report [single|multi] [tag]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
ARCH_ORDER = ["starcoder2-3b", "qwen2-72b", "gemma-2b", "gemma3-27b",
              "musicgen-medium", "phi-3-vision-4.2b", "deepseek-v3-671b",
              "granite-moe-1b-a400m", "mamba2-1.3b", "zamba2-2.7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(mesh: str, tag: str = ""):
    cells = {}
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            suffix = f"__{tag}" if tag else ""
            p = OUT_DIR / f"{arch}__{shape}__{mesh}{suffix}.json"
            if p.exists():
                cells[(arch, shape)] = json.loads(p.read_text())
    return cells


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def fmt_b(x):
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def roofline_table(mesh: str = "single", tag: str = "") -> str:
    cells = load_cells(mesh, tag)
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "useful/HLO | roofline-frac | mem/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            c = cells.get((arch, shape))
            if c is None:
                continue
            if c["status"].startswith("SKIP"):
                lines.append(f"| {arch} | {shape} | — | — | — | "
                             f"SKIP(full-attn) | — | — | — |")
                continue
            if c["status"] != "OK":
                lines.append(f"| {arch} | {shape} | — | — | — | "
                             f"{c['status']} | — | — | — |")
                continue
            r = c["roofline"]
            mem = c["memory_analysis"]
            dev_bytes = (mem["argument_bytes"] + mem["temp_bytes"]
                         + mem["output_bytes"] - mem["alias_bytes"])
            lines.append(
                f"| {arch} | {shape} | {fmt_s(r['compute_s'])} | "
                f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
                f"**{r['dominant']}** | {r['useful_flops_ratio']:.2f} | "
                f"{r['roofline_fraction']:.3f} | {fmt_b(dev_bytes)} |")
    return "\n".join(lines)


def dryrun_table(mesh: str) -> str:
    cells = load_cells(mesh)
    lines = [
        "| arch | shape | status | trace | params | flops/dev | "
        "collectives (count) |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            c = cells.get((arch, shape))
            if c is None:
                continue
            if c["status"].startswith("SKIP"):
                lines.append(f"| {arch} | {shape} | SKIP(full-attn) | — | — "
                             f"| — | — |")
                continue
            if c["status"] != "OK":
                lines.append(f"| {arch} | {shape} | {c['status']} | — | — "
                             f"| — | — |")
                continue
            r = c["roofline"]
            cc = ", ".join(f"{k.replace('collective-','c-')}:{v}"
                           for k, v in sorted(c["collective_counts"].items()))
            lines.append(
                f"| {arch} | {shape} | {c['status']} | {c['trace_s']}s | "
                f"{c['params_total']/1e9:.2f}B | {r['flops_per_device']:.2e} "
                f"| {cc or '—'} |")
    return "\n".join(lines)


def pick_hillclimb(mesh: str = "single"):
    cells = {k: v for k, v in load_cells(mesh).items()
             if v["status"] == "OK"}
    worst = min(cells.items(), key=lambda kv: kv[1]["roofline"]
                ["roofline_fraction"])
    coll = max(cells.items(), key=lambda kv: kv[1]["roofline"]["collective_s"]
               / max(kv[1]["roofline"]["compute_s"], 1e-12))
    return worst[0], coll[0]


if __name__ == "__main__":
    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    tag = sys.argv[2] if len(sys.argv) > 2 else ""
    print(roofline_table(mesh, tag))
    print()
    print(dryrun_table(mesh))
    print()
    print("hillclimb picks (worst-frac, most-collective):",
          pick_hillclimb(mesh))
