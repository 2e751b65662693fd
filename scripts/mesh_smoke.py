#!/usr/bin/env python3
"""Drive the PyTorch port on all four cards of one host, over NCCL, and hold
each run against the same job on one card.

Run from the root of a checkout, on a host with four NVIDIA H100s:

    PYTHONPATH=src python3 scripts/mesh_smoke.py

It builds the kernels once (``chip_smoke.environment``), starts the dry
run's counts (one CPU process each, on a fake process group of the card
run's shape), runs the one-card references in a process of its own on card
0, then starts ``python3 -m torch.distributed.run --standalone
--nproc-per-node 4`` on itself for each mesh, (4, 1), (2, 2) and (1, 4),
as (data, model), one process a card.  Each rank writes what it found into
``build/mesh_smoke/``; this process holds it against the references and
prints one line a phase:

``[mesh_parity]``  fp32, TF32 off: full-width gemma-2b and
    granite-moe-1b-a400m, each cut to 2 layers, 3 lake-fed steps of 4 x 1024
    on each mesh; losses and parameters against the one-card run to 1e-4
    relative (a parameter also within the share of its learning rates that
    its first moments leave unknown, as ``tests/test_torch_distributed.py``
    holds it: Adam moves an element by about one rate a step whatever its
    gradient's size).
``[mesh_train]``  bf16 at full depth, ``chip_smoke.TRAIN_JOB``'s 8 lake-fed
    steps (granite from ``chip_smoke.zipf_lake``): gemma-2b on every mesh,
    granite on (2, 2) and (1, 4); step s (median of steps 2-8), tokens/s,
    each rank's ``max_memory_allocated``, rank 0's device ms by group (the
    NCCL kernels a group of their own), beside the one-card run; losses
    fall, the first within 2e-2 of the one-card run's.
``[mesh_ckpt]``  gemma-2b's (2, 2) state saved, restored onto (4, 1) leaf
    for leaf equal, and one more step from the restored checkpoint.
``[mesh_serve]``  gemma-2b served at batch 4 on (4, 1) and on (1, 4): fp32
    greedy tokens equal to one card's; bf16 tokens/s and a decode step's
    idle share beside one card's.
``[mesh_seq_split]``  on (1, 4), decode on a cache split over the four
    cards by ``--seq-shard``'s rules, against the whole cache on one card
    within ``chip_smoke._close`` at ``TOL``: gemma-2b's ``gqa_decode``
    (B=4, T=32768, bf16, the decode kernel's partial entry, the merge over
    NCCL) and one ``mla_decode`` layer at deepseek-v3's widths (B=4,
    T=32768, fp32, the absorbed partial).
``[mesh_allreduce]``  on (4, 1), ``quantized_psum`` over a tree of
    gemma-2b's gradient shapes (fp32, each rank's drawn from its own seed)
    against ``dist.all_reduce`` of the same tree in fp32 and in bf16: ms and
    the bytes each rank puts on the wire (the int8 payload is summed as
    int32, as in JAX); the int8 mean within its quantization bound of the
    fp32 mean.
``[mesh_dryrun]``  each ``[mesh_train]`` step counted by the dry run on a
    fake group of the same shape: each rank's state bytes and kernel calls
    exactly; the predicted peak, collectives by kind and bound beside the
    measured peak and step s.

Every phase runs even if one before it failed; the exit code is not 0 if
fewer than four cards are visible or any gate failed.  The card's name and
power limit come before the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4}}``.

``--cpu`` rehearses the whole script on the CPU with gloo ranks, the smoke
configs and small shapes (no card, no kernel, no timing worth reading).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.launch.serve as serve_lib  # noqa: E402
import repro_torch.launch.train as train_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch, reduce_for_smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.storage import MemoryProvider  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    collective_wire_bytes, quantized_psum)
from repro_torch.launch.mesh import (destroy, init_from_env,  # noqa: E402
                                     make_local_mesh)
from repro_torch.launch.serve import Server, ServeJob  # noqa: E402
from repro_torch.launch.steps import (state_placements,  # noqa: E402
                                      train_state_specs)
from repro_torch.launch.train import Trainer, TrainJob  # noqa: E402
from repro_torch.models import abstract, build_model, named_leaves  # noqa: E402

OUT = ROOT / "build" / "mesh_smoke"
GEMMA, GRANITE = "gemma-2b", cs.GRANITE
PARITY_ARCHS = (GEMMA, GRANITE)
PARITY_LAYERS, PARITY_STEPS = 2, 3
PARITY_RTOL = 1e-4                # tests/test_kernels.py's gradient tolerance
FIRST_LOSS_RTOL = cs.TRAIN_RTOL   # 2e-2
PROFILED_STEPS = 2                # device ms by group: a step's mean over 2
REF_TIMEOUT_S = 240               # the one-card references
RUN_TIMEOUT_S = 360               # one torchrun, all its phases
# the whole script's: a run still going at the deadline is stopped (each
# rank has written every phase it finished) and the lines are printed
DEADLINE_S = 800


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which mesh runs which phase.  The four-card plan is the script's;
    ``--one-card`` runs every phase on a (1, 1) mesh of one rank, to check
    the script on one card before it takes four."""
    cards: int = 4
    meshes: tuple = ((4, 1), (2, 2), (1, 4))
    train: tuple = (("gemma-2b", ((4, 1), (2, 2), (1, 4))),
                    (cs.GRANITE, ((2, 2), (1, 4))))
    ckpt: tuple = ((2, 2), (4, 1))        # saved on, restored onto
    serve: tuple = ((4, 1), (1, 4))
    seq: tuple = (1, 4)
    allreduce: tuple = (4, 1)


ONE_CARD = Plan(cards=1, meshes=((1, 1),),
                train=(("gemma-2b", ((1, 1),)), (cs.GRANITE, ((1, 1),))),
                ckpt=((1, 1), (1, 1)), serve=((1, 1),), seq=(1, 1),
                allreduce=(1, 1))


def _name(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _say(tag: str, **fields) -> None:
    print(f"[{tag}] " + json.dumps(fields, default=str), flush=True)


# ------------------------------------------------------------------ jobs
def parity_job(arch: str, cpu: bool, model_axis: int = 1) -> TrainJob:
    """3 steps of 4 x 1024 from the trainer's own lake, one loader worker
    (the order every rank draws)."""
    return TrainJob(arch=arch, smoke=cpu, steps=PARITY_STEPS, global_batch=4,
                    seq_len=32 if cpu else 1024, warmup=2, num_docs=16,
                    checkpoint_every=100, log_every=100, loader_workers=1,
                    model_axis=model_axis, device="cpu" if cpu else None)


def train_job(arch: str, cpu: bool, model_axis: int = 1) -> TrainJob:
    base = cs.TRAIN_JOB if arch == GEMMA else cs.GRANITE_JOB
    job = dataclasses.replace(base, loader_workers=1, model_axis=model_axis,
                              log_every=100)
    if cpu:
        job = dataclasses.replace(job, smoke=True, steps=4, seq_len=32,
                                  device="cpu")
    return job


def serve_job(cpu: bool, model_axis: int = 1) -> ServeJob:
    return ServeJob(arch=GEMMA, smoke=cpu, batch=4,
                    prompt_len=8 if cpu else 32,
                    max_new_tokens=8 if cpu else 32, model_axis=model_axis,
                    device="cpu" if cpu else None)


def prompts(vocab: int, job: ServeJob) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, vocab, (job.batch, job.prompt_len)).astype(np.int32)


@contextlib.contextmanager
def arch_override(**changes):
    """``Trainer`` and ``Server`` built within take their config with
    ``changes`` (fp32, a cut depth): the entry points read it from
    ``get_arch`` by name, as a user's job names it."""
    saved = train_lib.get_arch, serve_lib.get_arch
    train_lib.get_arch = serve_lib.get_arch = \
        lambda name: saved[0](name).with_(**changes)
    try:
        yield
    finally:
        train_lib.get_arch, serve_lib.get_arch = saved


class _Kept(CheckpointManager):
    """A trainer's checkpoint manager that keeps nothing: its final save is
    not what the phase measures (``[mesh_ckpt]`` saves for real)."""

    def save(self, state, step, **kw):
        self.saved_steps.append(step)


def _lake(arch: str, job: TrainJob, cpu: bool):
    """Granite learns from a Zipf lake (chip_smoke's); gemma-2b's trainer
    makes its own."""
    if arch != GRANITE:
        return None
    vocab = (get_arch(arch) if not cpu else
             reduce_for_smoke(get_arch(arch))).vocab_size
    return cs.zipf_lake(job, vocab)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gb(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _whole(tree) -> dict:
    """{path: fp32 tensor} of a tree, each DTensor gathered whole."""
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().float() for k, v in named_leaves(tree)}


def _local_bytes(tree) -> int:
    return sum((v.to_local() if hasattr(v, "to_local") else v).numel()
               * v.element_size() for _, v in named_leaves(tree))


def _lr_sum(trainer, steps: int) -> float:
    return sum(float(trainer.opt.learning_rate(torch.tensor(s)))
               for s in range(1, steps + 1))


def _unknown_steps(trainer) -> dict:
    """{path: the share of its learning rates by which each parameter's
    Adam steps are not known}, filled as ``trainer`` steps.  Adam moves an
    element by about one rate a step whatever its gradient's size; where
    the element's first moment after a step is smaller than its leaf's
    largest, that step is known only to a relative ``PARITY_RTOL`` x
    max|m| / |m| (at most 2 rates: the two runs' steps pointing apart).
    ``tests/test_torch_distributed.py::_same_training`` takes it from the
    last step's moment; here each step counts, since a gradient that is
    near zero at the first step alone (Adam's eps then sets its step)
    leaves that step unknown."""
    slack, step_fn, done = {}, trainer.step_fn, [0]

    def recorded(state, batch):
        state, metrics = step_fn(state, batch)
        done[0] += 1
        lr = float(trainer.opt.learning_rate(torch.tensor(done[0])))
        for path, m in named_leaves(state["opt"]["m"]):
            m = m.detach().float().abs()
            known = torch.clamp(PARITY_RTOL * m.max() / m, max=2.0)
            slack[path] = slack.get(path, 0.0) + lr * known
        return state, metrics
    trainer.step_fn = recorded
    return slack


def _step_s(history) -> float:
    return statistics.median(h["sec"] for h in history[1:])


def _profiled(fn, rank: int, device, what):
    """``what(fn)`` on rank 0 (a profile of ``fn``), and ``fn`` called as
    often on every other rank, whose collectives rank 0's calls meet."""
    calls = {cs.device_ms_by_group: 1 + PROFILED_STEPS,
             cs.kernel_times: 1 + 2 * PROFILED_STEPS}[what]
    if torch.device(device).type != "cuda":
        return None
    if rank == 0:
        return what(fn, PROFILED_STEPS) if what is cs.device_ms_by_group \
            else what(fn, calls=PROFILED_STEPS)
    for _ in range(calls):
        fn()
    _sync(device)
    return None


def _decode_step(srv, B: int, T: int):
    """One decode step of ``srv`` at a T-slot cache's last position, as a
    function of nothing (a cache placed on the server's mesh)."""
    cache = srv.model.init_cache(B, T, srv.device)
    if srv.mesh is not None:
        cache = srv._place(srv.model.cache_specs(B, T), cache)
    tokens = np.zeros((B,), np.int32)

    def step():
        with (torch.no_grad() if srv.mesh is not None
              else torch.inference_mode()):
            srv._step(cache, tokens, T - 1)
    return step


# ------------------------------------------------------------ references
def role_ref(cpu: bool, plan: Plan) -> None:
    """The one-card runs, on card 0 (or the CPU): parity states to
    ``parity_<arch>.pt``, the rest to ``ref.json``."""
    device = "cpu" if cpu else "cuda:0"
    if not cpu:
        torch.cuda.set_device(0)
    out = {"parity": {}, "train": {}, "serve": {}}
    for arch in PARITY_ARCHS:
        with arch_override(dtype="float32", num_layers=PARITY_LAYERS):
            t = Trainer(parity_job(arch, cpu), ckpt=_Kept(MemoryProvider()))
        slack = _unknown_steps(t)
        res = t.run(restore=False)
        st = res["state"]
        losses = [h["loss"] for h in res["history"]]
        torch.save({"losses": losses, "params": _whole(st["params"]),
                    "slack": slack, "lr_sum": _lr_sum(t, PARITY_STEPS)},
                   OUT / f"parity_{arch}.pt")
        out["parity"][arch] = {"losses": losses}
        del t, res, st
        _empty(device)
    for arch, _ in plan.train:
        job = train_job(arch, cpu)
        _reset_peak(device)
        t = Trainer(job, ckpt=_Kept(MemoryProvider()),
                    data_ds=_lake(arch, job, cpu))
        cs._reset_counts()
        res = t.run(restore=False)
        launches = cs._counts()
        st = res["state"]
        batch = next(t._batches())
        groups = _profiled(lambda: t.step_fn(st, batch), 0, device,
                           cs.device_ms_by_group)
        step_s = _step_s(res["history"])
        out["train"][arch] = {
            "losses": [h["loss"] for h in res["history"]], "step_s": step_s,
            "tokens_per_s": job.global_batch * job.seq_len / step_s,
            "peak_gb": _peak_gb(device), "launches": launches,
            "device_ms_by_group": groups}
        del t, res, st, batch
        _empty(device)
    job = serve_job(cpu)
    with arch_override(dtype="float32"):
        srv = Server(job)
    out["serve"]["fp32_tokens"] = srv.generate(
        prompts(srv.cfg.vocab_size, job)).tolist()
    del srv
    _empty(device)
    srv = Server(job)
    srv.generate(prompts(srv.cfg.vocab_size, job))
    out["serve"]["bf16"] = {
        "tokens_per_s": srv.throughput(),
        "decode_step": _profiled(_decode_step(srv, job.batch, 64), 0, device,
                                 cs.kernel_times)}
    (OUT / "ref.json").write_text(json.dumps(out))


def _empty(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------- a mesh run
class Rank:
    """One torchrun rank's phases on one mesh shape; each phase's result
    (or its error) into ``mesh_<shape>_rank<r>.json``."""

    def __init__(self, mesh, cpu: bool, plan: Plan):
        self.shape, self.cpu, self.plan = mesh, cpu, plan
        self.device = init_from_env("cpu" if cpu else None)
        self.rank = dist.get_rank()
        self.results = {}
        self.launches = dict.fromkeys(cs.COUNTED, 0)
        self.path = OUT / f"mesh_{_name(mesh)}_rank{self.rank}.json"

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            got = fn(*args)
        except Exception:
            got = {"error": traceback.format_exc()[-4000:]}
        got["phase_s"] = time.perf_counter() - t0
        self.results[name] = got
        self.results["launches"] = self.launches
        self.path.write_text(json.dumps(self.results, default=str))
        _empty(self.device)

    def _count(self):
        counts = cs._counts()
        for k, v in counts.items():
            self.launches[k] += v
        return counts

    # ---------------------------------------------------------- parity
    def parity(self, arch: str) -> dict:
        with arch_override(dtype="float32", num_layers=PARITY_LAYERS):
            t = Trainer(parity_job(arch, self.cpu, self.shape[1]),
                        ckpt=_Kept(MemoryProvider()))
        assert tuple(t.mesh.shape) == self.shape, t.mesh.shape
        res = t.run(restore=False)
        losses = [h["loss"] for h in res["history"]]
        params, m = _whole(res["state"]["params"]), \
            _whole(res["state"]["opt"]["m"])
        out = {"losses": losses}
        if self.rank == 0:
            out.update(_held(losses, params, m, torch.load(
                OUT / f"parity_{arch}.pt", map_location=self.device)))
        return out

    # ----------------------------------------------------------- train
    def train(self, arch: str, ckpt=None) -> dict:
        job = train_job(arch, self.cpu, self.shape[1])
        _reset_peak(self.device)
        t = Trainer(job, ckpt=ckpt or _Kept(MemoryProvider()),
                    data_ds=_lake(arch, job, self.cpu))
        cs._reset_counts()
        res = t.run(restore=False)
        counts = self._count()
        peak = _peak_gb(self.device)
        st = res["state"]
        step_s = _step_s(res["history"])
        out = {"losses": [h["loss"] for h in res["history"]],
               "step_s": step_s,
               "tokens_per_s": job.global_batch * job.seq_len / step_s,
               "peak_gb": peak, "launches": counts, "steps": job.steps,
               "state_bytes": _local_bytes(st)}
        if ckpt is not None:        # before the profiled steps move ``st``
            out["ckpt"] = self._restore(t, st, ckpt)
        batch = next(t._batches())
        _reset_peak(self.device)     # the steps alone, not init_state's draw
        out["device_ms_by_group"] = _profiled(
            lambda: t.step_fn(st, batch), self.rank, self.device,
            cs.device_ms_by_group)
        out["step_peak_gb"] = _peak_gb(self.device)
        return out

    def _restore(self, saved_by, state, ckpt) -> dict:
        """[mesh_ckpt]: ``state`` (saved on this mesh at the last step)
        restored onto ``plan.ckpt[1]``, each leaf equal to the saved one;
        then one more step of that mesh's trainer from the restored state."""
        job = dataclasses.replace(saved_by.job, model_axis=self.plan.ckpt[1][1],
                                  steps=saved_by.job.steps + 1)
        t = Trainer(job, ckpt=ckpt, data_ds=saved_by.data_ds)
        step = ckpt.latest_step(mesh=t.mesh)
        _sync(self.device)
        t0 = time.perf_counter()
        back = ckpt.restore(
            abstract(train_state_specs(t.model, t.opt)), step,
            device=self.device, mesh=t.mesh,
            shardings=state_placements(t.model, t.opt, t.mesh, t.rules))
        _sync(self.device)
        restore_s = time.perf_counter() - t0
        mine, theirs = dict(named_leaves(state)), dict(named_leaves(back))
        equal = mine.keys() == theirs.keys()
        for k in mine:           # one leaf whole at a time
            a, b = mine[k].full_tensor(), theirs[k].full_tensor()
            equal = equal and a.dtype == b.dtype and torch.equal(a, b)
            del a, b
        del mine, theirs
        back, metrics = t.step_fn(back, next(t._batches()))
        return {"saved_step": step, "restored_mesh": list(t.mesh.shape),
                "equal": bool(equal), "restore_s": restore_s,
                "save_s": ckpt.copy_s + ckpt.write_s,
                "save_copy_s": ckpt.copy_s, "save_write_s": ckpt.write_s,
                "next_loss": float(metrics["loss"])}

    # ----------------------------------------------------------- serve
    def serve(self) -> dict:
        job = serve_job(self.cpu, self.shape[1])
        with arch_override(dtype="float32"):
            srv = Server(job)
        assert tuple(srv.mesh.shape) == self.shape, srv.mesh.shape
        p = prompts(srv.cfg.vocab_size, job)
        fp32 = srv.generate(p).tolist()
        del srv
        _empty(self.device)
        srv = Server(job)
        cs._reset_counts()
        srv.generate(p)
        counts = self._count()
        return {"fp32_tokens": fp32, "tokens_per_s": srv.throughput(),
                "launches": counts,
                "decode_step": _profiled(_decode_step(srv, job.batch, 64),
                                         self.rank, self.device,
                                         cs.kernel_times)}

    # ------------------------------------------------------- seq split
    def seq_split(self) -> dict:
        mesh = make_local_mesh(self.shape[1], torch.device(self.device).type)
        T = 4096 if self.cpu else cs.KEY_SPLIT["T"]
        # its launches (the partial entry's, checked per position) are in
        # its own line, not in the main path's count
        gqa = cs.key_split_decode(mesh, self.device, T=T)
        mla = cs.mla_key_split_decode(mesh, self.device, T=T)
        return {"gqa": gqa, "mla": mla, "T": T}

    # ------------------------------------------------------- allreduce
    def allreduce(self) -> dict:
        cfg = get_arch(GEMMA)
        if self.cpu:
            cfg = reduce_for_smoke(cfg)
        specs = build_model(cfg).param_specs()
        gen = torch.Generator(self.device).manual_seed(100 + self.rank)
        tree = {k: torch.randn(s.shape, generator=gen, device=self.device)
                for k, s in named_leaves(specs)}
        n = dist.get_world_size()

        def timed(fn, reps=3):
            fn()
            ts = []
            for _ in range(reps):
                dist.barrier()
                _sync(self.device)
                t0 = time.perf_counter()
                fn()
                _sync(self.device)
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        quant = {}
        q_ms = timed(lambda: quant.update(
            {k: quantized_psum(v) for k, v in tree.items()}))
        f32 = {k: v.clone() for k, v in tree.items()}
        f32_ms = timed(lambda: [dist.all_reduce(v) for v in f32.values()])
        bf16 = {k: v.bfloat16() for k, v in tree.items()}
        bf16_ms = timed(lambda: [dist.all_reduce(v) for v in bf16.values()])
        del bf16
        # the fp32 mean, and the int8 mean's bound from every rank's scales
        mean = {k: v.clone() for k, v in tree.items()}
        for v in mean.values():
            dist.all_reduce(v)
            v /= n
        scales = torch.stack([(v.abs().max() + 1e-12) / 127
                              for v in tree.values()])
        every = [torch.empty_like(scales) for _ in range(n)]
        dist.all_gather(every, scales)
        every = torch.stack(every)                   # (ranks, leaves)
        worst = 0.0
        for i, k in enumerate(tree):
            s = every[:, i]
            # |sum_r q_r (S/n - s_r) - sum_r e_r| / n, |q_r| <= 127 and each
            # rounding error |e_r| <= s_r / 2; and the fp32 rounding of
            # the result (127 s at most), a few ulps
            bound = (127 * (s.sum() / n - s).abs().sum() + s.sum() / 2) / n \
                + 127 * s.max() * 2.0 ** -21
            err = (quant[k] - mean[k]).abs().max()
            worst = max(worst, float(err / bound))
        elems = sum(v.numel() for v in tree.values())
        ring = 2 * (n - 1) / n
        return {"leaves": len(tree), "elements": elems,
                "quantized_ms": q_ms, "fp32_ms": f32_ms, "bf16_ms": bf16_ms,
                "err_over_bound": worst,
                "payload_bytes": {
                    "int8_as_jax_counts": collective_wire_bytes(tree, True),
                    "int32_summed": elems * 4 + len(tree) * 8,
                    "fp32": elems * 4, "bf16": elems * 2},
                "ring_bytes_a_rank": {
                    "int32_summed": ring * (elems * 4 + len(tree) * 8),
                    "fp32": ring * elems * 4, "bf16": ring * elems * 2}}


def _held(losses, params, m, ref) -> dict:
    """A meshed parity run against the one-card one: losses to
    ``PARITY_RTOL`` relative; each parameter within ``PARITY_RTOL`` of its
    leaf's largest plus the learning rates its first moments leave unknown
    (:func:`_unknown_steps`).  With the worst element's numbers."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    worst, where = 0.0, None
    for path, w in ref["params"].items():
        slack = PARITY_RTOL * w.abs().max() + ref["slack"][path].double()
        diff = (params[path].double() - w.double()).abs()
        over = diff / slack
        i = int(over.argmax())
        if float(over.flatten()[i]) > worst:
            worst, where = float(over.flatten()[i]), {
                "leaf": path, "index": i, "shape": list(w.shape),
                "diff": float(diff.flatten()[i]),
                "slack": float(slack.flatten()[i]),
                "w_max": float(w.abs().max()),
                "m_mesh": float(m[path].flatten()[i]),
                "m_mesh_max": float(m[path].abs().max()),
                "leaf_diff_max": float(diff.max())}
    return {"loss_rel_max": rel, "params_over_slack_max": worst,
            "params_worst": where, "lr_sum": ref["lr_sum"],
            "held": rel <= PARITY_RTOL and worst <= 1.0}


def role_mesh(shape, cpu: bool, plan: Plan) -> None:
    r = Rank(shape, cpu, plan)
    if not cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in PARITY_ARCHS:
            r.run(f"parity {arch}", r.parity, arch)
        for arch, meshes in plan.train:
            if shape not in meshes:
                continue
            ckpt = None
            if arch == GEMMA and shape == plan.ckpt[0]:
                ckpt = cs._TimedCheckpoints(MemoryProvider(), keep=1)
            r.run(f"train {arch}", r.train, arch, ckpt)
        if shape in plan.serve:
            r.run("serve", r.serve)
        if shape == plan.seq:
            r.run("seq_split", r.seq_split)
        if shape == plan.allreduce:
            r.run("allreduce", r.allreduce)
    finally:
        destroy()


# ---------------------------------------------------------------- dry run
def role_dryrun(arch: str, shape, cpu: bool) -> None:
    """The dry run's count of ``[mesh_train]``'s step of ``arch`` on a fake
    group of ``shape`` (this process rank 0), into ``dryrun_<arch>_<shape>
    .json``."""
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.roofline import (Roofline, active_param_count,
                                             model_flops)
    from repro_torch.launch.steps import trace_cell
    job = train_job(arch, cpu)
    cfg = get_arch(arch)
    if cpu:
        cfg = reduce_for_smoke(cfg)
    sc = ShapeConfig(f"train_{job.global_batch}x{job.seq_len}", job.seq_len,
                     job.global_batch, "train")
    mesh = make_fake_mesh(shape=shape)
    t0 = time.perf_counter()
    costs, memory, model, _ = trace_cell(cfg, sc, mesh)
    rl = Roofline(arch=arch, shape=sc.name, mesh=_name(shape),
                  chips=mesh.size(), flops_per_device=costs.flops,
                  bytes_per_device=costs.hbm_bytes,
                  collective_bytes=costs.collective_bytes,
                  collective_breakdown={k: int(v) for k, v in
                                        costs.collective_by_kind.items()},
                  peak_memory_per_device=costs.peak_bytes,
                  model_flops_total=model_flops(
                      cfg, sc, active_param_count(cfg, model)),
                  flops_by_dtype=costs.flops_by_dtype,
                  collective_bytes_across_nodes=costs
                  .collective_bytes_across_nodes)
    (OUT / f"dryrun_{arch}_{_name(shape)}.json").write_text(json.dumps({
        "trace_s": time.perf_counter() - t0,
        "state_bytes": memory["state_bytes"],
        "kernel_calls": costs.kernel_calls, "peak_bytes": costs.peak_bytes,
        "collective_by_kind": costs.collective_by_kind,
        "collective_count": costs.collective_count,
        "bound_s": rl.bound_s, "dominant": rl.dominant,
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "collective_s": rl.collective_s}))


# --------------------------------------------------- the leading process
def _start(args, env, **kw):
    """This script in a process of its own, leading a process group of its
    own (so that a stop reaches every process it starts)."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             *args], env=env, cwd=ROOT,
                            start_new_session=True, **kw)


def _wait(proc, timeout: float, what: str, t_start: float) -> int:
    timeout = max(1.0, min(timeout, t_start + DEADLINE_S
                           - time.perf_counter()))
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)    # torchrun and its ranks
        proc.wait()
        print(f"[mesh_smoke] {what} killed after {timeout} s", flush=True)
        return -9


def _load(path: Path):
    return json.loads(path.read_text()) if path.exists() else None


def _error(got) -> str:
    if got is None:
        return "no result"
    return got.get("error") if isinstance(got, dict) else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=("lead", "ref", "mesh", "dryrun"),
                    default="lead")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on gloo CPU ranks at the smoke configs")
    ap.add_argument("--one-card", action="store_true",
                    help="every phase on a (1, 1) mesh of one card")
    args = ap.parse_args()
    plan = ONE_CARD if args.one_card else Plan()
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    if args.role == "ref":
        role_ref(args.cpu, plan)
        return 0
    if args.role == "mesh":
        role_mesh(shape, args.cpu, plan)
        return 0
    if args.role == "dryrun":
        role_dryrun(args.arch, shape, args.cpu)
        return 0
    return lead(args.cpu, plan, ["--one-card"] if args.one_card else [])


def lead(cpu: bool, plan: Plan, passed: list) -> int:
    t_start = time.perf_counter()
    if not cpu and torch.cuda.device_count() < plan.cards:
        print(f"mesh_smoke: {torch.cuda.device_count()} CUDA devices visible, "
              f"{plan.cards} needed", file=sys.stderr)
        return 1
    card = None
    if not cpu:
        card = cs.environment()            # the kernels built once, here
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    flag = (["--cpu"] if cpu else []) + passed
    # the dry run's counts, on the CPU beside the card runs
    cpu_env = dict(env, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    dry = {(arch, m): _start(["--role", "dryrun", "--arch", arch, "--mesh",
                              _name(m), *flag], cpu_env,
                             stdout=subprocess.DEVNULL,
                             stderr=open(OUT / f"dryrun_{arch}_{_name(m)}.err",
                                         "w"))
           for arch, meshes in plan.train for m in meshes}
    failed = []
    t0 = time.perf_counter()
    rc = _wait(_start(["--role", "ref", *flag],
                      dict(env, CUDA_VISIBLE_DEVICES="0") if not cpu else env),
               REF_TIMEOUT_S, "the one-card references", t_start)
    ref_s = time.perf_counter() - t0
    ref = _load(OUT / "ref.json")
    if rc != 0 or ref is None:
        failed.append("references")
        ref = {"parity": {}, "train": {}, "serve": {}}
    _say("mesh_ref", card=card, rc=rc, s=ref_s, train={
        a: {k: v for k, v in r.items() if k != "losses"} | {
            "first_loss": r["losses"][0], "last_loss": r["losses"][-1]}
        for a, r in ref["train"].items()},
        serve=ref["serve"].get("bf16"))
    runs = {}
    for m in plan.meshes:
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(plan.cards),
               str(Path(__file__).resolve()), "--role", "mesh", "--mesh",
               _name(m), *flag]
        rc = _wait(subprocess.Popen(cmd, env=env, cwd=ROOT,
                                    start_new_session=True), RUN_TIMEOUT_S,
                   f"the {_name(m)} run", t_start)
        runs[m] = [_load(OUT / f"mesh_{_name(m)}_rank{r}.json") or {}
                   for r in range(plan.cards)]
        _say("mesh_run", mesh=list(m), rc=rc, s=time.perf_counter() - t0)
        if rc != 0:
            failed.append(f"run {_name(m)}")
    failed += report(runs, ref, plan, card)
    for (arch, m), p in dry.items():
        _wait(p, RUN_TIMEOUT_S, f"the dry run of {arch} on {_name(m)}",
              t_start)
    failed += report_dryrun(runs, plan, cpu, card)
    launches = {k: sum(r.get("launches", {}).get(k, 0) for ranks in
                       runs.values() for r in ranks) for k in cs.COUNTED}
    _say("mesh_done", card=card, failed=failed, launches_across_cards=launches,
         script_s=time.perf_counter() - t_start)
    if failed:
        return 1
    if cpu:
        print(json.dumps({"ok": True, "device": {"platform": "cpu",
                                                 "count": plan.cards}}))
        return 0
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _phase(ranks, name):
    """Every rank's result of a phase, and the first error among them."""
    got = [r.get(name) for r in ranks]
    err = next((e for e in (_error(g) for g in got) if e), None)
    return got, err


def report(runs, ref, plan: Plan, card) -> list:
    """One line a phase and mesh; -> the names of the gates that failed."""
    failed = []
    for m, ranks in runs.items():
        for arch in PARITY_ARCHS:
            got, err = _phase(ranks, f"parity {arch}")
            r0 = got[0] or {}
            ok = err is None and r0.get("held") is True and all(
                g["losses"] == r0["losses"] for g in got)
            _say("mesh_parity", card=card, arch=arch, mesh=list(m),
                 layers=PARITY_LAYERS, steps=PARITY_STEPS, dtype="float32",
                 rtol=PARITY_RTOL, held=ok, error=err, **{
                     k: r0.get(k) for k in ("loss_rel_max",
                                            "params_over_slack_max",
                                            "params_worst", "lr_sum",
                                            "losses")},
                 ref_losses=ref["parity"].get(arch, {}).get("losses"))
            if not ok:
                failed.append(f"parity {arch} {_name(m)}")
        for arch, meshes in plan.train:
            if m not in meshes:
                continue
            got, err = _phase(ranks, f"train {arch}")
            one = ref["train"].get(arch)
            ok = err is None and one is not None
            line = {}
            if ok:
                r0 = got[0]
                losses = r0["losses"]
                first = abs(losses[0] - one["losses"][0]) / \
                    abs(one["losses"][0])
                ok = losses[-1] < losses[0] and first <= FIRST_LOSS_RTOL \
                    and all(g["losses"] == losses for g in got)
                line = dict(
                    losses=losses, first_loss_rel=first,
                    step_s=r0["step_s"], tokens_per_s=r0["tokens_per_s"],
                    peak_gb_by_rank=[g["peak_gb"] for g in got],
                    launches_by_rank=[g["launches"] for g in got],
                    device_ms_by_group=r0["device_ms_by_group"],
                    one_card={k: one[k] for k in (
                        "step_s", "tokens_per_s", "peak_gb",
                        "device_ms_by_group")},
                    phase_s=r0["phase_s"])
                if "ckpt" in r0:
                    c = r0["ckpt"]
                    cok = c["equal"] and math.isfinite(c["next_loss"])
                    _say("mesh_ckpt", card=card, arch=arch, saved_on=list(m),
                         **c, held=cok)
                    if not cok:
                        failed.append("ckpt")
            _say("mesh_train", card=card, arch=arch, mesh=list(m), held=ok,
                 error=err, **line)
            if not ok:
                failed.append(f"train {arch} {_name(m)}")
        if m in plan.serve:
            got, err = _phase(ranks, "serve")
            want = ref["serve"].get("fp32_tokens")
            ok = err is None and want is not None and all(
                g["fp32_tokens"] == want for g in got)
            r0 = got[0] or {}
            _say("mesh_serve", card=card, mesh=list(m), held=ok, error=err,
                 fp32_tokens_equal=ok,
                 tokens_per_s=r0.get("tokens_per_s"),
                 decode_step=r0.get("decode_step"),
                 one_card=ref["serve"].get("bf16"),
                 launches_by_rank=[(g or {}).get("launches") for g in got])
            if not ok:
                failed.append(f"serve {_name(m)}")
        if m == plan.seq:
            got, err = _phase(ranks, "seq_split")
            _say("mesh_seq_split", card=card, mesh=list(m), held=err is None,
                 error=err, by_rank=got)
            if err is not None:
                failed.append("seq_split")
        if m == plan.allreduce:
            got, err = _phase(ranks, "allreduce")
            ok = err is None and all(g["err_over_bound"] <= 1.0 for g in got)
            r0 = got[0] or {}
            _say("mesh_allreduce", card=card, mesh=list(m), held=ok,
                 error=err, **{k: v for k, v in r0.items()},
                 ms_by_rank={k: [(g or {}).get(k) for g in got] for k in (
                     "quantized_ms", "fp32_ms", "bf16_ms")})
            if not ok:
                failed.append("allreduce")
    return failed


def report_dryrun(runs, plan: Plan, cpu: bool, card) -> list:
    """``[mesh_dryrun]``: each train step's count against every rank."""
    failed = []
    for arch, meshes in plan.train:
        for m in meshes:
            pred = _load(OUT / f"dryrun_{arch}_{_name(m)}.json")
            got = [r.get(f"train {arch}") for r in runs[m]]
            err = next((e for e in (_error(g) for g in got) if e), None)
            if pred is None:
                err = (OUT / f"dryrun_{arch}_{_name(m)}.err").read_text()[
                    -3000:]
            ok = err is None
            line = {}
            if ok:
                calls = [{k: v // g["steps"] for k, v in g["launches"].items()
                          if v} for g in got]
                state = [g["state_bytes"] for g in got]
                ok = all(s == pred["state_bytes"] for s in state) and (
                    cpu or all(c == pred["kernel_calls"] for c in calls))
                line = dict(
                    state_bytes={"predicted": pred["state_bytes"],
                                 "by_rank": state},
                    kernel_calls={"predicted": pred["kernel_calls"],
                                  "by_rank": calls},
                    peak_gb={"predicted": pred["peak_bytes"] / 1e9,
                             "steps_by_rank": [g["step_peak_gb"]
                                               for g in got],
                             "run_by_rank": [g["peak_gb"] for g in got]},
                    collective_by_kind=pred["collective_by_kind"],
                    collective_count=pred["collective_count"],
                    bound_s=pred["bound_s"], dominant=pred["dominant"],
                    compute_s=pred["compute_s"], memory_s=pred["memory_s"],
                    collective_s=pred["collective_s"],
                    step_s=got[0]["step_s"],
                    bound_over_step=pred["bound_s"] / got[0]["step_s"],
                    trace_s=pred["trace_s"])
            _say("mesh_dryrun", card=card, arch=arch, mesh=list(m), held=ok,
                 error=err, **line)
            if not ok:
                failed.append(f"dryrun {arch} {_name(m)}")
    return failed


if __name__ == "__main__":
    sys.exit(main())
