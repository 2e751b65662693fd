"""Trees of the port side by side on four cards: one served decode step
of gemma-2b, one of deepseek-v3-671b (cut to 4 layers) and one of
mamba2-1.3b on a (1, 4) mesh, and one mamba2-1.3b train step on (2, 2),
each timed and traced by every rank, for each tree in turn in one call.

    python3 scripts/mesh_ab.py --roots build/a,build/b,.,.,build/b,build/a
    python3 scripts/mesh_ab.py --roots build/a,.,.,build/a --steps mamba
    PYTHONPATH=src python3 scripts/mesh_ab.py --cpu --roots ...  # gloo, smoke

A tree is a checkout of the repository (``git archive`` of a commit unpacked
into a directory that ``.gitignore`` lists); each runs with its own
``src/``, ``chip_smoke.py`` and ``scripts/mesh_smoke.py``, whose jobs and
helpers it uses: ``[mesh_serve]``'s bf16 decode step at a 64-slot cache's
last position (batch 4, full width; gemma-2b and mamba2 at full depth,
deepseek-v3 at ``[mesh_serve]``'s bf16 depth) and, but for mamba2's, its
tokens/s over one ``generate`` of the job's prompts, and
``[mesh_train]``'s mamba2 step (full depth).  ``--steps`` runs some of
them only.  The
kernels are built once, in parallel, and handed to every tree (a
library's name carries its source's digest).

For each tree, one line ``[mesh_ab] {...}``: per step (``decode``,
``deepseek``, ``mamba``, ``train``), the wall ms without the profiler (rank 0's),
then from a ``torch.profiler`` trace of as many
calls on every rank: device busy ms and the NCCL kernels' share of it (the
largest rank's), the aten ops and the collectives dispatched a call, and the
host ops with the most self time (rank 0's).  The card's name and power
limit come before the last line, which is ``{"ok": ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mesh_ab"
CALLS = {"decode": 4, "deepseek": 4, "mamba": 4, "train": 1}
# the served decode steps: (arch, whether its tokens/s over a generate is
# taken); mamba2's is not (a tree whose meshed step gathers the SSM state
# takes ~1 s a token on (1, 4), a minute a generate)
SERVED = {"decode": ("gemma-2b", True), "deepseek": ("deepseek-v3-671b", True),
          "mamba": ("mamba2-1.3b", False)}
RUN_TIMEOUT_S = {False: 300, True: 600}      # a tree's run, by --cpu


def trace(fn, calls: int, device) -> dict:
    """``fn``'s wall ms a call, then a profile of ``calls`` more calls."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    wall = (time.perf_counter() - t0) / calls * 1e3
    dist.barrier()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        sync()
    busy = nccl = 0.0
    ops, coll, host = 0, Counter(), {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                ms = e.self_device_time_total / 1e3 / calls
                busy += ms
                nccl += ms if "nccl" in e.key.lower() else 0.0
            continue
        ops += e.count if e.key.startswith("aten::") else 0
        if e.key.startswith(("_c10d_functional::", "_dtensor::")) and \
                e.key.split("::")[1] not in ("wait_tensor",
                                             "_wrap_tensor_autograd"):
            coll[e.key.split("::")[1]] += e.count / calls
        host[e.key] = e.self_cpu_time_total / 1e3 / calls
    top = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "busy_ms": busy, "nccl_ms": nccl,
            "idle_share": 1 - busy / wall if cuda else None,
            "aten_ops": ops / calls, "collectives": dict(coll),
            "host_top_ms": dict(top)}


def role_rank(root: Path, cpu: bool, out: Path, steps) -> None:
    """One torchrun rank of one tree: its ``steps``."""
    sys.path[:0] = [str(root / "scripts"), str(root / "src"), str(root)]
    import mesh_smoke as ms
    from repro_torch.core.storage import MemoryProvider
    from repro_torch.launch.mesh import destroy, init_from_env
    from repro_torch.launch.serve import Server
    from repro_torch.launch.train import Trainer
    device = init_from_env("cpu" if cpu else None)
    res = {"rank": dist.get_rank()}
    try:
        for step, (arch, generate) in SERVED.items():
            if step not in steps:
                continue
            job = ms.serve_job(arch, cpu, model_axis=4)
            layers = ms.SERVE_LAYERS.get(arch, (None, None))[1]
            with ms.arch_override(**ms.cut(arch, layers)):
                srv = Server(job)
            if generate:
                srv.generate(ms.prompts(srv.cfg.vocab_size, job))
            res[f"mesh_{step}"] = list(srv.mesh.shape)
            res[step] = dict(trace(ms._decode_step(srv, job.batch, 64),
                                   CALLS[step], device),
                             tokens_per_s=srv.throughput() if generate
                             else None, layers=srv.cfg.num_layers)
            del srv
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        if "train" in steps:
            job = dataclasses.replace(ms.train_job(ms.MAMBA2, cpu, 2),
                                      steps=1)
            t = Trainer(job, ckpt=ms._Kept(MemoryProvider()),
                        data_ds=ms._lake(ms.MAMBA2, job, cpu))
            st = t.run(restore=False)["state"]
            res["mesh_train"] = list(t.mesh.shape)
            batch = next(t._batches())
            res["train"] = trace(lambda: t.step_fn(st, batch),
                                 CALLS["train"], device)
    finally:
        Path(f"{out}.rank{dist.get_rank()}.json").write_text(json.dumps(res))
        destroy()


def _build_kernels() -> None:
    """Every kernel source of this tree built, all at once."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import load
    sources = sorted((ROOT / "src" / "repro_torch" / "kernels")
                     .glob("*/csrc/*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(load, sources))


def _card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _run(i: int, root: Path, cpu: bool, steps) -> dict:
    """One tree's torchrun -> its ``[mesh_ab]`` line."""
    for so in (ROOT / "build").glob("*.so"):
        if root.resolve() != ROOT and not (root / "build" / so.name).exists():
            (root / "build").mkdir(parents=True, exist_ok=True)
            shutil.copy2(so, root / "build" / so.name)
    out = OUT / str(i)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", __file__, "--role", "rank",
           "--root", str(root), "--out", str(out), "--steps",
           ",".join(steps)] + (["--cpu"] if cpu else [])
    env = dict(os.environ, OMP_NUM_THREADS="1" if cpu else
               os.environ.get("OMP_NUM_THREADS", "4"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=RUN_TIMEOUT_S[cpu])
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)     # torchrun and its ranks
        proc.wait()
        rc = 124
    ranks = [json.loads(p.read_text()) for p in
             sorted(OUT.glob(f"{i}.rank*.json"))]
    line = {"root": str(root), "rc": rc, "s": time.perf_counter() - t0}
    for step in steps:
        got = [r[step] for r in ranks if step in r]
        if len(got) != 4:
            continue
        first = next(r for r in ranks if r["rank"] == 0)
        line[step] = dict(first[step], mesh=first[f"mesh_{step}"],
                          busy_ms_max=max(g["busy_ms"] for g in got),
                          nccl_ms_max=max(g["nccl_ms"] for g in got))
    return line


def lead(roots, cpu: bool, steps) -> int:
    if not cpu and torch.cuda.device_count() < 4:
        print(f"mesh_ab: {torch.cuda.device_count()} CUDA devices visible, "
              "4 needed", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    for p in OUT.glob("*.json"):
        p.unlink()
    if not cpu:
        _build_kernels()
    ok = True
    for i, root in enumerate(roots):
        line = _run(i, Path(root), cpu, steps)
        ok &= line["rc"] == 0 and all(step in line for step in steps)
        print("[mesh_ab] " + json.dumps(line), flush=True)
    card = _card()
    if card:
        print(card)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", default=".",
                    help="the trees, in order, e.g. build/a,build/b,.,.,"
                         "build/b,build/a")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU, smoke configs")
    ap.add_argument("--steps", default=",".join(CALLS),
                    help="which steps, e.g. mamba or decode,train")
    ap.add_argument("--role", choices=("lead", "rank"), default="lead")
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    steps = tuple(args.steps.split(","))
    if any(step not in CALLS for step in steps):
        ap.error(f"--steps: each of {', '.join(CALLS)}")
    if args.role == "rank":
        role_rank(Path(args.root).resolve(), args.cpu, Path(args.out), steps)
        return 0
    return lead([r for r in args.roots.split(",")], args.cpu, steps)


if __name__ == "__main__":
    sys.exit(main())
