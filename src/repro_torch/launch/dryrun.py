"""Dry run of the production slice: prove that the port's distribution is
coherent on 256 or 512 ranks, and count one device's work, on a machine with
no GPU (port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell and mesh, one process:

    mesh = make_fake_mesh(multi_pod)      # a fake process group, rank 0
    costs, memory, ... = trace_cell(...)  # the real step on fake tensors
    Roofline(...)                         # on the H100 figures

``trace_cell`` (``launch/steps.py``) runs the port's own step once under
``FakeTensorMode`` with each rank's shards of the state and inputs, through
the kernels' route (each wrapper reports its call; nothing is built or
launched), and ``op_analysis.OpCounter`` counts the flops, bytes,
collectives and peak of live storage.  No byte of device memory is
allocated.

Results land in ``experiments/dryrun_torch/*.json`` (``--out`` elsewhere),
from which ``launch/report.py`` renders its tables.

A host's cards count the same way: ``--mesh 2x2`` (any ``DxM``) traces the
cell on a fake (data, model) group of that shape, and ``--batch`` and
``--seq-len`` cut the shape to a run that fits them (``scripts/
mesh_smoke.py`` holds such counts against four H100s).

Usage:
    python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh 2x2 --batch 4 --seq-len 1024
    python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             attn_impl: str = "kernel", microbatches: int = 1,
             grad_compress: bool = False, fsdp=None, remat=None,
             seq_shard: bool = False, tag: str = "", batch=None,
             seq_len=None, device_type: str = "cpu") -> dict:
    """One cell.  ``mesh_kind``: "single" (16, 16), "multi" (2, 16, 16), or
    "DxM", a (data, model) mesh of that shape; ``batch`` and ``seq_len``
    replace the shape's global batch and sequence length; ``device_type``
    is the fake mesh's ("cuda" needs a CUDA build of torch)."""
    from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.roofline import (Roofline, active_param_count,
                                             model_flops)
    from repro_torch.launch.steps import trace_cell
    from repro_torch.models.param import count_params

    cfg = ARCHS[arch]
    if seq_shard:
        cfg = cfg.with_(seq_shard_attn=True)
    shape_cfg = SHAPES[shape]
    if batch is not None or seq_len is not None:
        shape_cfg = dataclasses.replace(
            shape_cfg, global_batch=batch or shape_cfg.global_batch,
            seq_len=seq_len or shape_cfg.seq_len)
    if not cell_is_runnable(arch, shape):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "SKIP(full-attention)"}
    mesh = make_fake_mesh(multi_pod=(mesh_kind == "multi"),
                          shape=_host_shape(mesh_kind),
                          device_type=device_type)
    chips = mesh.size()
    t0 = time.time()
    costs, memory, model, _ = trace_cell(
        cfg, shape_cfg, mesh, attn_impl=attn_impl, microbatches=microbatches,
        grad_compress=grad_compress, fsdp=fsdp, remat=remat)
    trace_s = time.time() - t0
    n_active = active_param_count(cfg, model)
    rl = Roofline(
        arch=arch, shape=shape, mesh=mesh_kind, chips=chips,
        flops_per_device=costs.flops, bytes_per_device=costs.hbm_bytes,
        collective_bytes=costs.collective_bytes,
        collective_breakdown={k: int(v)
                              for k, v in costs.collective_by_kind.items()},
        peak_memory_per_device=costs.peak_bytes,
        model_flops_total=model_flops(cfg, shape_cfg, n_active),
        flops_by_dtype=costs.flops_by_dtype,
        collective_bytes_across_nodes=costs.collective_bytes_across_nodes,
    )
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "OK",
        "chips": chips, "kind": shape_cfg.kind,
        "batch": shape_cfg.global_batch, "seq_len": shape_cfg.seq_len,
        "params_total": count_params(model.param_specs()),
        "params_active": n_active,
        "trace_s": round(trace_s, 1),
        "memory_analysis": memory,
        "collective_counts": costs.collective_count,
        "kernel_calls": costs.kernel_calls,
        "flops_by_dtype": costs.flops_by_dtype,
        "roofline": rl.to_json(),
        "knobs": {"attn_impl": attn_impl, "microbatches": microbatches,
                  "grad_compress": grad_compress, "fsdp": fsdp,
                  "remat": remat},
        "tag": tag,
    }


def _host_shape(mesh_kind: str):
    """(data, model) of a "DxM" mesh kind; None for "single" and "multi"."""
    if mesh_kind in ("single", "multi"):
        return None
    return tuple(int(n) for n in mesh_kind.split("x"))


def cell_filename(arch: str, shape: str, mesh_kind: str, tag: str = "",
                  out_dir: Path = OUT_DIR) -> Path:
    suffix = f"__{tag}" if tag else ""
    return Path(out_dir) / f"{arch}__{shape}__{mesh_kind}{suffix}.json"


def _run_all(args) -> int:
    """Each cell in a process of its own (one fake group a process), up to
    ``--jobs`` at a time."""
    from repro_torch.configs import ARCHS, SHAPES
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh_kind in meshes:
                out = cell_filename(arch, shape, mesh_kind, args.tag, args.out)
                if args.skip_existing and out.exists():
                    print(f"skip (exists): {out.name}")
                    continue
                cells.append((arch, shape, mesh_kind))

    def one(cell):
        arch, shape, mesh_kind = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
               "--tag", args.tag, "--attn-impl", args.attn_impl,
               "--fake-device", args.fake_device, "--out", str(args.out)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
        except subprocess.TimeoutExpired:
            # recorded as the cell's result, so that no cell goes missing
            said = f"TIMEOUT after {args.timeout} s"
            cell_filename(arch, shape, mesh_kind, args.tag, args.out
                          ).write_text(json.dumps({
                              "arch": arch, "shape": shape, "mesh": mesh_kind,
                              "status": "ERROR", "error": said,
                              "tag": args.tag}, indent=2))
            return cell, said
        if r.returncode != 0:
            return cell, (f"FAIL rc={r.returncode}\n{r.stdout[-2000:]}"
                          f"\n{r.stderr[-4000:]}")
        lines = r.stdout.strip().splitlines()
        return cell, None if not lines else lines[-1]

    failures = 0
    with ThreadPoolExecutor(args.jobs) as pool:
        for (arch, shape, mesh_kind), said in pool.map(one, cells):
            print(f"=== {arch} x {shape} x {mesh_kind}", flush=True)
            if said is None or not said.startswith("{"):
                failures += 1
            print(said or "(no output)", flush=True)
    print(f"dry run done; failures={failures}")
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    help="single | multi | both | DxM (a host's cards)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attn-impl", default="kernel")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--remat", default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--fake-device", default="cpu", choices=("cpu", "cuda"),
                    help="the fake mesh's device type (cuda: a CUDA build)")
    # deepseek-v3's prefill_32k cells take ~80 min of a core
    ap.add_argument("--timeout", type=int, default=7200)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    if args.all:
        return _run_all(args)

    fsdp = None if args.fsdp is None else (args.fsdp == "on")
    try:
        result = run_cell(args.arch, args.shape, args.mesh,
                          attn_impl=args.attn_impl,
                          microbatches=args.microbatches,
                          grad_compress=args.grad_compress,
                          fsdp=fsdp, remat=args.remat,
                          seq_shard=args.seq_shard, tag=args.tag,
                          batch=args.batch, seq_len=args.seq_len,
                          device_type=args.fake_device)
    except Exception:
        traceback.print_exc()
        result = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "status": "ERROR", "error": traceback.format_exc()[-2000:],
                  "tag": args.tag}
    out = cell_filename(args.arch, args.shape, args.mesh, args.tag, args.out)
    out.write_text(json.dumps(result, indent=2))
    print(json.dumps({k: result.get(k) for k in
                      ("arch", "shape", "mesh", "status", "trace_s")}))
    return 0 if result.get("status", "ERROR") in ("OK",) or \
        str(result.get("status", "")).startswith("SKIP") else 1


if __name__ == "__main__":
    sys.exit(main())
