#!/usr/bin/env python3
"""Drive the PyTorch port on all four cards of one host, over NCCL, and hold
each run against the same job on one card.

Run from the root of a checkout, on a host with four NVIDIA H100s:

    PYTHONPATH=src python3 scripts/mesh_smoke.py [--part dense_moe|ssm_mla]

Each part is one invocation that ends inside 1200 s.  ``dense_moe`` (the
default) runs gemma-2b and granite-moe-1b-a400m, as set out below;
``ssm_mla`` runs the other three families' models on (2, 2) and (1, 4) with
the same phases, the same gates and the same references:

``[mesh_parity]``  fp32: mamba2-1.3b cut to 2 layers, 4 x 2048;
    zamba2-2.7b cut to one shared-block period (the shared block once and
    its 6 mamba layers), 4 x 1024; deepseek-v3-671b cut to 2 (dense)
    layers with its multi-token prediction, 4 x 1024; and the kernels'
    launches on each rank exact.
``[mesh_train]``  bf16: mamba2 at full depth, ``chip_smoke.MAMBA2_JOB``'s
    8 steps, on both meshes; deepseek-v3 at depth 3 with MTP,
    ``chip_smoke.DEEPSEEK_JOB``'s 8 steps, on (1, 4); the ssd scan's (and
    every kernel's) launches on each rank exact.
``[mesh_grad]``  bf16: full-width zamba2-2.7b, one loss and gradient of
    2 x 1024 on (2, 2) with no optimizer, as ``chip_smoke.zamba2`` runs
    it: loss and gradient norm within ``chip_smoke.TRAIN_RTOL`` of one
    card's, the ssd and flash launches (its shared block) exact.
``[mesh_serve]``  mamba2, zamba2 and deepseek-v3 on (1, 4): fp32 greedy
    tokens equal to one card's (deepseek-v3 at depth 3, under the decode
    rules); bf16 tokens/s and a decode step's idle share beside one card's
    (deepseek-v3 at depth 4, whose fourth layer is the MoE on expert
    shards); the decode kernel's launches exact; each rank's traced
    mamba2 and zamba2 decode step sends exactly the collectives that
    ``mamba_decode_collectives`` gives (and the logits' all-gather).
``[mesh_dryrun]``  the train steps as below; and deepseek-v3's (depth 4),
    mamba2's and zamba2's decode step (batch 4) counted on a fake (1, 4)
    group at two cache lengths, on a "cpu" and a "cuda" fake mesh, whose
    collectives must be equal: nothing a layer sends grows with the
    cache; no collective of it may be as large as one rank's vocab shard
    of the embedding table (each rank looks its tokens up in its own
    shard); a mamba step's collectives, by kind, count and bytes, are
    ``mamba_decode_collectives``'s (no SSM state gathered).  Each line
    gives the lookup's own collectives.

The ``dense_moe`` part:

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
    measured peak and step s; the embedding lookup's collectives.

``[mesh_parity]`` and ``[mesh_train]`` also give, for each rank, the
(local heads, group heads) that its ssd and flash calls were handed.
``--role dryrun|dryrun_decode --fake-device cuda`` counts one dry-run role
on a "cuda" fake mesh (a CUDA build of torch, no kernel launched), to hold
against the same role's count on the default "cpu" mesh.

Every phase runs even if one before it failed; the exit code is not 0 if
fewer than four cards are visible or any gate failed.  The card's name and
power limit come before the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4}}``.

``--cpu`` rehearses the whole script on the CPU with gloo ranks, the smoke
configs and small shapes (no card, no kernel, no timing worth reading).

A rank whose phase raises writes what it found and leaves at once: the
other ranks may be waiting in a collective it will not enter, and torchrun
then stops them, so that the run ends instead of hanging to its limit.
``--keep-going`` runs every phase instead, for a rehearsal whose faults are
the same on every rank (a torch version's).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
from typing import Optional

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
from repro_torch.distributed.sharding import (  # noqa: E402
    distribute, is_dtensor, make_rules, make_shard_fn, place_tree, replicate,
    sharding_for_specs)
from repro_torch.launch.mesh import (destroy, init_from_env,  # noqa: E402
                                     make_local_mesh)
from repro_torch.launch.serve import Server, ServeJob  # noqa: E402
from repro_torch.launch.steps import (state_placements,  # noqa: E402
                                      train_state_specs)
from repro_torch.launch.train import Trainer, TrainJob  # noqa: E402
from repro_torch.models import abstract, build_model, named_leaves  # noqa: E402

OUT = ROOT / "build" / "mesh_smoke"
GEMMA, GRANITE = "gemma-2b", cs.GRANITE
MAMBA2, ZAMBA2, DEEPSEEK = cs.MAMBA2_JOB.arch, "zamba2-2.7b", cs.DEEPSEEK
PARITY_STEPS = 3
# the depth each model is cut to, by phase (a model not named keeps its
# published depth): fp32 parity; bf16 training; serving, (fp32, bf16).
# zamba2 builds num_layers // 6 periods of its shared block and 6 mamba
# layers, in JAX as here, so 7 layers would build the same model as 6
PARITY_LAYERS = {GEMMA: 2, GRANITE: 2, MAMBA2: 2, ZAMBA2: 6, DEEPSEEK: 2}
TRAIN_LAYERS = {DEEPSEEK: cs.DEEPSEEK_TRAIN_LAYERS}
SERVE_LAYERS = {DEEPSEEK: (cs.DEEPSEEK_TRAIN_LAYERS, cs.DEEPSEEK_SERVE_LAYERS)}
PARITY_SEQ = {MAMBA2: 2048}       # the rest 1024, as their train jobs
GRAD_SHAPE = (2, 1024)            # chip_smoke.zamba2's pass
DECODE_DRY_T = (64, 32768)        # [mesh_dryrun]'s two cache lengths
PARITY_RTOL = 1e-4                # tests/test_kernels.py's gradient tolerance
FIRST_LOSS_RTOL = cs.TRAIN_RTOL   # 2e-2
PROFILED_STEPS = 2                # device ms by group: a step's mean over 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which mesh runs which phase of one part.  ``--one-card`` runs every
    phase of the part on a (1, 1) mesh of one rank, to check the script on
    one card before it takes four.  The time limits: the one-card
    references, one torchrun with all its phases, and the whole script's,
    at which a run still going is stopped (each rank has written every
    phase it finished) and the lines are printed."""
    cards: int = 4
    meshes: tuple = ((4, 1), (2, 2), (1, 4))
    parity: tuple = (GEMMA, GRANITE)
    train: tuple = ((GEMMA, ((4, 1), (2, 2), (1, 4))),
                    (GRANITE, ((2, 2), (1, 4))))
    grad: tuple = ()                      # (arch, meshes): no optimizer
    ckpt: tuple = ((2, 2), (4, 1))        # gemma-2b saved on, restored onto
    serve: tuple = ((GEMMA, ((4, 1), (1, 4))),)
    seq: Optional[tuple] = (1, 4)
    allreduce: Optional[tuple] = (4, 1)
    decode_dryrun: tuple = ()             # (arch, mesh)
    ref_s: float = 240
    run_s: float = 360
    deadline_s: float = 800


PARTS = {
    "dense_moe": Plan(),
    "ssm_mla": Plan(meshes=((2, 2), (1, 4)), parity=(MAMBA2, ZAMBA2, DEEPSEEK),
                    train=((MAMBA2, ((2, 2), (1, 4))), (DEEPSEEK, ((1, 4),))),
                    grad=((ZAMBA2, ((2, 2),)),), ckpt=(),
                    serve=((MAMBA2, ((1, 4),)), (ZAMBA2, ((1, 4),)),
                           (DEEPSEEK, ((1, 4),))),
                    seq=None, allreduce=None,
                    decode_dryrun=((DEEPSEEK, (1, 4)), (MAMBA2, (1, 4)),
                                   (ZAMBA2, (1, 4))),
                    ref_s=420, run_s=480, deadline_s=1080),
}


def only(plan: Plan, meshes) -> Plan:
    """``plan`` with the phases of ``meshes`` alone (a checkpoint saved on
    one of them is still restored onto its other mesh, in the same run)."""
    keep = lambda pairs: tuple((a, tuple(m for m in ms if m in meshes))
                               for a, ms in pairs
                               if any(m in meshes for m in ms))
    return dataclasses.replace(
        plan, meshes=tuple(m for m in plan.meshes if m in meshes),
        train=keep(plan.train), grad=keep(plan.grad),
        serve=keep(plan.serve),
        ckpt=plan.ckpt if plan.ckpt and plan.ckpt[0] in meshes else (),
        seq=plan.seq if plan.seq in meshes else None,
        allreduce=plan.allreduce if plan.allreduce in meshes else None,
        decode_dryrun=tuple((a, m) for a, m in plan.decode_dryrun
                            if m in meshes))


def one_card(plan: Plan) -> Plan:
    """``plan`` with every phase on a (1, 1) mesh of one card."""
    one = (1, 1)
    each = lambda pairs: tuple((a, (one,)) for a, _ in pairs)
    return dataclasses.replace(
        plan, cards=1, meshes=(one,), train=each(plan.train),
        grad=each(plan.grad), ckpt=(one, one) if plan.ckpt else (),
        serve=each(plan.serve), seq=one if plan.seq else None,
        allreduce=one if plan.allreduce else None,
        decode_dryrun=tuple((a, one) for a, _ in plan.decode_dryrun))


def _name(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _say(tag: str, **fields) -> None:
    print(f"[{tag}] " + json.dumps(fields, default=str), flush=True)


# ------------------------------------------------------------------ jobs
def parity_job(arch: str, cpu: bool, model_axis: int = 1) -> TrainJob:
    """3 steps of 4 x 1024 (mamba2: 4 x 2048) from the trainer's own lake,
    one loader worker (the order every rank draws)."""
    return TrainJob(arch=arch, smoke=cpu, steps=PARITY_STEPS, global_batch=4,
                    seq_len=32 if cpu else PARITY_SEQ.get(arch, 1024),
                    warmup=2, num_docs=16, checkpoint_every=100,
                    log_every=100, loader_workers=1, model_axis=model_axis,
                    device="cpu" if cpu else None)


TRAIN_JOBS = {GEMMA: cs.TRAIN_JOB, GRANITE: cs.GRANITE_JOB,
              MAMBA2: cs.MAMBA2_JOB, DEEPSEEK: cs.DEEPSEEK_JOB}


def train_job(arch: str, cpu: bool, model_axis: int = 1) -> TrainJob:
    job = dataclasses.replace(TRAIN_JOBS[arch], loader_workers=1,
                              model_axis=model_axis, log_every=100)
    if cpu:
        job = dataclasses.replace(job, smoke=True, steps=4, seq_len=32,
                                  device="cpu")
    return job


def serve_job(arch: str, cpu: bool, model_axis: int = 1) -> ServeJob:
    return ServeJob(arch=arch, smoke=cpu, batch=4,
                    prompt_len=8 if cpu else 32,
                    max_new_tokens=8 if cpu else 32, model_axis=model_axis,
                    device="cpu" if cpu else None)


def prompts(vocab: int, job: ServeJob) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, vocab, (job.batch, job.prompt_len)).astype(np.int32)


def cut(arch: str, layers: Optional[int], **changes) -> dict:
    """``changes`` and the config changes that cut ``arch`` to its first
    ``layers`` layers (none for ``None``); an MoE model's leading dense
    layers are cut with it."""
    if layers is not None:
        changes["num_layers"] = layers
        moe = get_arch(arch).moe
        if moe is not None and moe.first_dense_layers > layers:
            changes["moe"] = dataclasses.replace(moe,
                                                 first_dense_layers=layers)
    return changes


def mamba_decode_collectives(cfg, batch: int) -> Optional[dict]:
    """The collectives of a served decode step of an ssm or hybrid ``cfg``
    at ``batch`` on a (1, 4) mesh, as the dry run counts them (the
    server's all-gather of the logits apart): the lookup's all-reduce of
    the (B, 1, d) rows; per mamba layer two all-gathers, the projection's
    (B, 1, proj_out) row and the convolution's output row (B, 1, conv_dim),
    and two all-reduces, the gated norm's fp32 (B, 1, 1) sum of squares
    and the output's (B, 1, d) pending sum; two all-reduces of (B, 1, d) a
    shared-block invocation (zamba2).  No all-gather of the SSM state.  At
    full width, batch 4: mamba2-1.3b 96 all-gathers (4,939,776 B) and 97
    all-reduces (803,584 B); zamba2-2.7b 108 (6,780,672 B) and 127
    (1,495,904 B).  None for a family with no mamba layer."""
    from repro_torch.models.param import torch_dtype
    if cfg.family not in ("ssm", "hybrid"):
        return None
    s, d, item = cfg.ssm, cfg.d_model, torch_dtype(cfg.dtype).itemsize
    conv = cfg.expand_dim + 2 * s.n_groups * s.d_state
    proj = 2 * cfg.expand_dim + 2 * s.n_groups * s.d_state + cfg.ssm_heads
    shared, layers = 0, cfg.num_layers
    if cfg.family == "hybrid":
        P = cfg.hybrid.shared_attn_period
        shared, layers = cfg.num_layers // P, cfg.num_layers // P * P
    rows = 1 + layers + 2 * shared            # (B, 1, d) all-reduces
    return {"collective_count": {"all-gather": 2 * layers,
                                 "all-reduce": rows + layers},
            "collective_by_kind": {
                "all-gather": layers * batch * (proj + conv) * item,
                "all-reduce": rows * batch * d * item + layers * batch * 4}}


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
    """Granite, mamba2 and deepseek-v3 learn from a Zipf lake, as in
    chip_smoke; gemma-2b's trainer makes its own."""
    if arch == GEMMA:
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
            if m.numel() == 0:          # a stack of no layers
                slack[path] = torch.zeros(m.shape)
                continue
            m = m.detach().float().abs()
            known = torch.clamp(PARITY_RTOL * m.max() / m, max=2.0)
            # on the host: deepseek-v3's would be 14.8 GB beside its state
            slack[path] = slack.get(path, 0.0) + (lr * known).cpu()
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


def _collectives(fn, calls: int = 2) -> dict:
    """The collectives ``fn`` dispatches a call on this rank, by kind, from
    a ``torch.profiler`` trace of ``calls`` calls (the host's record of each
    ``_c10d_functional`` op; every rank calls ``fn`` as often)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.op_analysis import COLLECTIVES
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    got = {}
    for e in prof.key_averages():
        ns, _, op = e.key.partition("::")
        if ns == "_c10d_functional" and op in COLLECTIVES:
            kind = COLLECTIVES[op]
            got[kind] = got.get(kind, 0) + e.count / calls
    return got


# --------------------------------------------------- the phases' work
def _parity_trainer(arch: str, cpu: bool, model_axis: int) -> Trainer:
    with arch_override(**cut(arch, PARITY_LAYERS[arch], dtype="float32")):
        return Trainer(parity_job(arch, cpu, model_axis),
                       ckpt=_Kept(MemoryProvider()))


def _train(arch: str, cpu: bool, model_axis: int, device, ckpt=None):
    """``[mesh_train]``'s run of ``arch`` -> (its numbers, the trainer,
    its final state), the launches counted over the run."""
    job = train_job(arch, cpu, model_axis)
    _reset_peak(device)
    with arch_override(**cut(arch, TRAIN_LAYERS.get(arch))):
        t = Trainer(job, ckpt=ckpt or _Kept(MemoryProvider()),
                    data_ds=_lake(arch, job, cpu))
    cs._reset_counts()
    res = t.run(restore=False)
    counts = cs._counts()
    peak = _peak_gb(device)
    st = res["state"]
    step_s = _step_s(res["history"])
    out = {"losses": [h["loss"] for h in res["history"]], "step_s": step_s,
           "tokens_per_s": job.global_batch * job.seq_len / step_s,
           "peak_gb": peak, "launches": counts, "steps": job.steps,
           "launches_want": _every_kernel(cs.train_launches(t.cfg,
                                                            job.steps)),
           "layers": t.cfg.num_layers, "state_bytes": _local_bytes(st)}
    return out, t, st


def _profile_train(out: dict, t: Trainer, st, rank: int, device) -> dict:
    """``out`` with rank 0's profile of the steps after the run (each rank
    runs them) and their peak."""
    batch = next(t._batches())
    _reset_peak(device)          # the steps alone, not init_state's draw
    out["device_ms_by_group"] = _profiled(lambda: t.step_fn(st, batch), rank,
                                          device, cs.device_ms_by_group)
    out["step_peak_gb"] = _peak_gb(device)
    return out


@contextlib.contextmanager
def _handed(out: dict):
    """While active, each distinct (local heads, group heads) pair that the
    ssd scan and the flash kernel were handed, into ``out`` by kernel: on a
    model axis wider than the groups, a rank is handed the groups its heads
    read (``sharding.local_call``)."""
    import repro_torch.kernels.ssd_scan as ssd_pkg
    import repro_torch.models.attention as attn_lib
    seen = {"ssd_scan": set(), "flash_attention": set()}
    real_ssd, real_flash = ssd_pkg.ssd, attn_lib.flash_attention

    def ssd(x, dt, A, Bm, Cm, **kw):
        seen["ssd_scan"].add((x.shape[2], Bm.shape[2]))
        return real_ssd(x, dt, A, Bm, Cm, **kw)

    def flash(q, k, v, **kw):
        seen["flash_attention"].add((q.shape[2], k.shape[2]))
        return real_flash(q, k, v, **kw)
    ssd_pkg.ssd, attn_lib.flash_attention = ssd, flash
    try:
        yield
    finally:
        ssd_pkg.ssd, attn_lib.flash_attention = real_ssd, real_flash
        out.update({k: sorted(v) for k, v in seen.items() if v})


def _every_kernel(want: dict) -> dict:
    return {name: want.get(name, 0) for name in cs.COUNTED}


def _loss_and_grad_norm(model, params, batch):
    """(loss, the gradients' global norm) of one batch, both fp32, the same
    on every rank: ``chip_smoke.loss_and_grad_norm`` on DTensors too (each
    gradient placed as its parameter, as the train step places it)."""
    with model.spmd():
        loss, _, grads = cs._loss_and_grads(model, params, batch)
        sq = 0.0
        for g, (_, p) in zip(grads, named_leaves(params)):
            if is_dtensor(p):
                g = distribute(g, p.device_mesh, p.placements)
            part = g.float().square().sum()
            sq += float(replicate(part).to_local() if is_dtensor(part)
                        else part)
        loss = replicate(loss.detach()).to_local() if is_dtensor(loss) \
            else loss
    return float(loss), math.sqrt(sq)


def _grad(arch: str, cpu: bool, model_axis: int, device) -> dict:
    """``[mesh_grad]``: one loss and gradient of full-width ``arch`` on a
    seeded batch, no optimizer; the params drawn whole from seed 0 on every
    rank and placed by the train rules.  Twice: the launches counted over
    both, each pass timed."""
    B, S = (2, 32) if cpu else GRAD_SHAPE
    cfg = get_arch(arch)
    if cpu:
        cfg = reduce_for_smoke(cfg)
    mesh = make_local_mesh(model_axis, torch.device(device).type)
    rules = make_rules("train")
    model = build_model(cfg, shard_fn=make_shard_fn(mesh, rules))
    _reset_peak(device)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    if mesh is not None:
        params = place_tree(params, sharding_for_specs(model.param_specs(),
                                                       mesh, rules), mesh)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to(device)
    batch = {"tokens": model.shard(tokens[:, :-1], ("batch", None)),
             "targets": model.shard(tokens[:, 1:], ("batch", None))}
    cs._reset_counts()
    secs, got = [], None
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        got = _loss_and_grad_norm(model, params, batch)
        _sync(device)
        secs.append(time.perf_counter() - t0)
    return {"loss": got[0], "grad_norm": got[1], "seconds": secs,
            "launches": cs._counts(),
            "launches_want": _every_kernel(cs.train_launches(cfg, 2)),
            "batch": [B, S], "peak_gb": _peak_gb(device)}


def _serve(arch: str, cpu: bool, model_axis: int, rank: int, device,
           mesh_shape=None) -> dict:
    """``[mesh_serve]``: fp32 greedy tokens, then bf16 tokens/s, the decode
    kernel's launches and a decode step's profile (rank 0's; each rank
    runs the steps), each model cut as ``SERVE_LAYERS`` says."""
    job = serve_job(arch, cpu, model_axis)
    fp32_layers, bf16_layers = SERVE_LAYERS.get(arch, (None, None))
    with arch_override(**cut(arch, fp32_layers, dtype="float32")):
        srv = Server(job)
    if mesh_shape is not None:
        assert tuple(srv.mesh.shape) == mesh_shape, srv.mesh.shape
    p = prompts(srv.cfg.vocab_size, job)
    fp32 = srv.generate(p).tolist()
    del srv
    _empty(device)
    with arch_override(**cut(arch, bf16_layers)):
        srv = Server(job)
    cs._reset_counts()
    srv.generate(p)
    counts = cs._counts()
    total = job.prompt_len + job.max_new_tokens
    return {"fp32_tokens": fp32, "tokens_per_s": srv.throughput(),
            "launches": counts, "layers": [fp32_layers, srv.cfg.num_layers],
            "launches_want": _every_kernel({"decode_attention": cs
                                            ._attention_layers(srv.cfg)
                                            * total}),
            "decode_step": _profiled(_decode_step(srv, job.batch, 64), rank,
                                     device, cs.kernel_times),
            "collectives": _collectives(_decode_step(srv, job.batch, 64)),
            "collectives_want": _served_collectives(srv.cfg, job.batch)}


def _served_collectives(cfg, batch: int) -> Optional[dict]:
    """What a served mamba decode step sends on (1, 4), by kind: the dry
    run's count (``mamba_decode_collectives``) and the server's all-gather
    of the logits; None for a family with no mamba layer."""
    want = mamba_decode_collectives(cfg, batch)
    if want is None:
        return None
    count = dict(want["collective_count"])
    count["all-gather"] += 1
    return count


# ------------------------------------------------------------ references
def role_ref(cpu: bool, plan: Plan) -> None:
    """The one-card runs, on card 0 (or the CPU): parity states to
    ``parity_<arch>.pt``, the rest to ``ref.json``."""
    device = "cpu" if cpu else "cuda:0"
    if not cpu:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"parity": {}, "train": {}, "grad": {}, "serve": {},
           "errors": {}}

    def parity(arch):
        t = _parity_trainer(arch, cpu, 1)
        slack = _unknown_steps(t)
        cs._reset_counts()
        res = t.run(restore=False)
        launches = cs._counts()
        st = res["state"]
        losses = [h["loss"] for h in res["history"]]
        torch.save({"losses": losses, "params": _whole(st["params"]),
                    "slack": slack, "lr_sum": _lr_sum(t, PARITY_STEPS)},
                   OUT / f"parity_{arch}.pt")
        return {"losses": losses, "launches": launches}

    def train(arch):
        got, t, st = _train(arch, cpu, 1, device)
        return _profile_train(got, t, st, 0, device)
    phases = [("parity", a, parity) for a in plan.parity] + \
        [("train", a, train) for a, _ in plan.train] + \
        [("grad", a, lambda a: _grad(a, cpu, 1, device))
         for a, _ in plan.grad] + \
        [("serve", a, lambda a: _serve(a, cpu, 1, 0, device))
         for a, _ in plan.serve]
    # one phase's fault leaves the others' references (one process: no
    # collective to hang)
    for kind, arch, fn in phases:
        try:
            out[kind][arch] = fn(arch)
        except Exception:
            out["errors"][f"{kind} {arch}"] = traceback.format_exc()[-3000:]
        _empty(device)
        (OUT / "ref.json").write_text(json.dumps(out))


def _empty(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------- a mesh run
class Rank:
    """One torchrun rank's phases on one mesh shape; each phase's result
    (or its error) into ``mesh_<shape>_rank<r>.json``."""

    def __init__(self, mesh, cpu: bool, plan: Plan, keep_going: bool):
        self.shape, self.cpu, self.plan = mesh, cpu, plan
        self.keep_going = keep_going
        self.device = init_from_env("cpu" if cpu else None)
        self.rank = dist.get_rank()
        self.results = {}
        self.launches = dict.fromkeys(cs.COUNTED, 0)
        self.path = OUT / f"mesh_{_name(mesh)}_rank{self.rank}.json"

    def run(self, name, fn, *args):
        """A phase; if it raises, its error is written and this process
        leaves (see the module's docstring)."""
        t0 = time.perf_counter()
        failed = False
        try:
            got = fn(*args)
        except Exception:
            got = {"error": traceback.format_exc()[-4000:]}
            failed = True
        got["phase_s"] = time.perf_counter() - t0
        self.results[name] = got
        self.results["launches"] = self.launches
        self.path.write_text(json.dumps(self.results, default=str))
        if failed and not self.keep_going:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        _empty(self.device)

    def _count(self, counts: dict) -> dict:
        for k, v in counts.items():
            self.launches[k] += v
        return counts

    # ---------------------------------------------------------- parity
    def parity(self, arch: str) -> dict:
        t = _parity_trainer(arch, self.cpu, self.shape[1])
        assert tuple(t.mesh.shape) == self.shape, t.mesh.shape
        cs._reset_counts()
        groups = {}
        with _handed(groups):
            res = t.run(restore=False)
        out = {"losses": [h["loss"] for h in res["history"]],
               "launches": self._count(cs._counts()), "groups": groups}
        st = res["state"]
        ref = torch.load(OUT / f"parity_{arch}.pt", map_location="cpu",
                         mmap=True) if self.rank == 0 else None
        held = _Held(out["losses"], ref, self.device)
        m = dict(named_leaves(st["opt"]["m"]))
        for path, w in named_leaves(st["params"]):   # one leaf whole at a time
            if w.numel() == 0:      # a stack of no layers (deepseek-v3's MoE)
                continue
            w, mw = _full(w), _full(m[path])       # every rank gathers
            if ref is not None:
                held.leaf(path, w, mw)
            del w, mw
        if ref is not None:
            out.update(held.result())
        return out

    # ----------------------------------------------------------- train
    def train(self, arch: str, ckpt=None) -> dict:
        groups = {}
        with _handed(groups):
            out, t, st = _train(arch, self.cpu, self.shape[1], self.device,
                                ckpt)
        out["groups"] = groups
        assert tuple(t.mesh.shape) == self.shape, t.mesh.shape
        self._count(out["launches"])
        if ckpt is not None:        # before the profiled steps move ``st``
            out["ckpt"] = self._restore(t, st, ckpt)
        return _profile_train(out, t, st, self.rank, self.device)
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

    # ------------------------------------------------------------ grad
    def grad(self, arch: str) -> dict:
        out = _grad(arch, self.cpu, self.shape[1], self.device)
        self._count(out["launches"])
        return out

    # ----------------------------------------------------------- serve
    def serve(self, arch: str) -> dict:
        out = _serve(arch, self.cpu, self.shape[1], self.rank, self.device,
                     self.shape)
        self._count(out["launches"])
        return out

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


def _full(x: torch.Tensor) -> torch.Tensor:
    """A leaf whole in fp32 (a DTensor gathered: every rank must call)."""
    return (x.full_tensor() if hasattr(x, "full_tensor") else x) \
        .detach().float()


class _Held:
    """A meshed parity run against the one-card one (``ref``, as
    ``role_ref`` saved it): losses to ``PARITY_RTOL`` relative; each
    parameter within ``PARITY_RTOL`` of its leaf's largest plus the
    learning rates its first moments leave unknown (:func:`_unknown_steps`),
    held one leaf at a time, in pieces of ``CHUNK`` elements.  With the
    worst element's numbers."""
    CHUNK = 1 << 26

    def __init__(self, losses, ref, device):
        self.ref, self.device = ref, device
        self.rel = None if ref is None else max(
            abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        self.worst, self.where = 0.0, None

    def leaf(self, path: str, w_mesh, m_mesh) -> None:
        w = self.ref["params"][path].to(self.device).reshape(-1)
        slack_all = self.ref["slack"][path].reshape(-1)
        w_max = float(w.abs().max())
        got, m = w_mesh.reshape(-1), m_mesh.reshape(-1)
        for lo in range(0, w.numel(), self.CHUNK):
            hi = lo + self.CHUNK
            slack = PARITY_RTOL * w_max + \
                slack_all[lo:hi].to(self.device).double()
            diff = (got[lo:hi].double() - w[lo:hi].double()).abs()
            over = diff / slack
            i = int(over.argmax())
            if float(over[i]) > self.worst:
                self.worst, self.where = float(over[i]), {
                    "leaf": path, "index": lo + i,
                    "shape": list(self.ref["params"][path].shape),
                    "diff": float(diff[i]), "slack": float(slack[i]),
                    "w_max": w_max, "m_mesh": float(m[lo + i]),
                    "m_mesh_max": float(m.abs().max())}
            del slack, diff, over

    def result(self) -> dict:
        return {"loss_rel_max": self.rel, "params_over_slack_max": self.worst,
                "params_worst": self.where, "lr_sum": self.ref["lr_sum"],
                "held": self.rel <= PARITY_RTOL and self.worst <= 1.0}


def role_mesh(shape, cpu: bool, plan: Plan, keep_going: bool) -> None:
    r = Rank(shape, cpu, plan, keep_going)
    if not cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in plan.parity:
            r.run(f"parity {arch}", r.parity, arch)
        for arch, meshes in plan.train:
            if shape not in meshes:
                continue
            ckpt = None
            if arch == GEMMA and plan.ckpt and shape == plan.ckpt[0]:
                ckpt = cs._TimedCheckpoints(MemoryProvider(), keep=1)
            r.run(f"train {arch}", r.train, arch, ckpt)
        for arch, meshes in plan.grad:
            if shape in meshes:
                r.run(f"grad {arch}", r.grad, arch)
        for arch, meshes in plan.serve:
            if shape in meshes:
                r.run(f"serve {arch}", r.serve, arch)
        if shape == plan.seq:
            r.run("seq_split", r.seq_split)
        if shape == plan.allreduce:
            r.run("allreduce", r.allreduce)
    finally:
        destroy()


# ---------------------------------------------------------------- dry run
def _dry_name(role: str, arch: str, shape, fake_device: str) -> str:
    """The file stem of a dry-run role's count; a "cuda" fake mesh's is
    marked so."""
    suffix = "" if fake_device == "cpu" else f"_{fake_device}"
    return f"{role}_{arch}_{_name(shape)}{suffix}"


def _lookup(costs, cfg, mesh) -> dict:
    """The collectives of a traced step's embedding lookups
    (``Model.lookup``), beside the bytes of one rank's vocab shard of the
    table."""
    from repro_torch.models.param import torch_dtype
    lookup = costs.scoped.get("lookup", {"by_kind": {}, "count": {}})
    rows = cfg.padded_vocab // dict(zip(mesh.mesh_dim_names,
                                        mesh.shape))["model"]
    return {"collective_by_kind": lookup["by_kind"],
            "collective_count": lookup["count"],
            "table_shard_bytes": rows * cfg.d_model
            * torch_dtype(cfg.dtype).itemsize}


def role_dryrun(arch: str, shape, cpu: bool, fake_device: str = "cpu"
                ) -> None:
    """The dry run's count of ``[mesh_train]``'s step of ``arch`` on a fake
    group of ``shape`` (this process rank 0) whose mesh is of
    ``fake_device``, into ``dryrun_<arch>_<shape>.json`` (``_cuda`` before
    the suffix on a "cuda" mesh)."""
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.roofline import (Roofline, active_param_count,
                                             model_flops)
    from repro_torch.launch.steps import trace_cell
    job = train_job(arch, cpu)
    cfg = get_arch(arch).with_(**cut(arch, TRAIN_LAYERS.get(arch)))
    if cpu:
        cfg = reduce_for_smoke(cfg)
    sc = ShapeConfig(f"train_{job.global_batch}x{job.seq_len}", job.seq_len,
                     job.global_batch, "train")
    mesh = make_fake_mesh(shape=shape, device_type=fake_device)
    t0 = time.perf_counter()
    costs, memory, model, _ = trace_cell(cfg, sc, mesh)
    trace_s = time.perf_counter() - t0
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
    (OUT / f"{_dry_name('dryrun', arch, shape, fake_device)}.json"
     ).write_text(json.dumps({
        "trace_s": trace_s, "lookup": _lookup(costs, cfg, mesh),
        "state_bytes": memory["state_bytes"],
        "kernel_calls": costs.kernel_calls, "peak_bytes": costs.peak_bytes,
        "collective_by_kind": costs.collective_by_kind,
        "collective_count": costs.collective_count,
        "bound_s": rl.bound_s, "dominant": rl.dominant,
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "collective_s": rl.collective_s}))


def role_dryrun_decode(arch: str, shape, cpu: bool,
                       fake_device: str = "cpu") -> None:
    """The dry run's count of ``arch``'s bf16 served decode step (its depth
    as ``[mesh_serve]`` serves it, batch 4) on a fake group of ``shape``
    whose mesh is of ``fake_device``, at each of ``DECODE_DRY_T``, and of
    its embedding lookups, into ``dryrun_decode_<arch>_<shape>.json``
    (``_cuda`` before the suffix on a "cuda" mesh)."""
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.steps import trace_cell
    cfg = get_arch(arch).with_(**cut(arch, SERVE_LAYERS.get(arch,
                                                           (None, None))[1]))
    if cpu:
        cfg = reduce_for_smoke(cfg)
    mesh = make_fake_mesh(shape=shape, device_type=fake_device)
    # a mamba decode step's collectives on (1, 4), as they should count
    out = {"layers": cfg.num_layers, "by_T": {}, "want": (
        mamba_decode_collectives(cfg, 4) if tuple(shape) == (1, 4) else None)}
    for T in DECODE_DRY_T:
        t0 = time.perf_counter()
        sc = ShapeConfig(f"decode_{T}", T, 4, "decode")
        costs, memory, _, _ = trace_cell(cfg, sc, mesh)
        out["by_T"][T] = {"collective_by_kind": costs.collective_by_kind,
                          "collective_count": costs.collective_count,
                          "largest_collective": costs.largest_collective,
                          "peak_bytes": memory["peak_bytes"],
                          "trace_s": time.perf_counter() - t0,
                          "lookup": _lookup(costs, cfg, mesh)}
    (OUT / f"{_dry_name('dryrun_decode', arch, shape, fake_device)}.json"
     ).write_text(json.dumps(out))


# --------------------------------------------------- the leading process
def _start(args, env, **kw):
    """This script in a process of its own, leading a process group of its
    own (so that a stop reaches every process it starts)."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             *args], env=env, cwd=ROOT,
                            start_new_session=True, **kw)


def _wait(proc, timeout: float, what: str, deadline: float) -> int:
    timeout = max(1.0, min(timeout, deadline - time.perf_counter()))
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
    ap.add_argument("--role", choices=("lead", "ref", "mesh", "dryrun",
                                       "dryrun_decode"), default="lead")
    ap.add_argument("--part", choices=sorted(PARTS), default="dense_moe",
                    help="which models and phases (each part one "
                         "invocation)")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on gloo CPU ranks at the smoke configs")
    ap.add_argument("--one-card", action="store_true",
                    help="every phase on a (1, 1) mesh of one card")
    ap.add_argument("--keep-going", action="store_true",
                    help="a rank whose phase raises runs the next phase")
    ap.add_argument("--meshes", default=None,
                    help="run only these of the part's meshes, e.g. "
                         "2x2,1x4")
    ap.add_argument("--fake-device", default="cpu", choices=("cpu", "cuda"),
                    help="the dry-run roles' fake mesh (cuda: the card "
                         "host's CUDA build, which DTensor dispatches as on "
                         "the cards)")
    args = ap.parse_args()
    plan = PARTS[args.part]
    if args.meshes:
        plan = only(plan, [tuple(int(x) for x in m.split("x"))
                           for m in args.meshes.split(",")])
    if args.one_card:
        plan = one_card(plan)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    if args.role == "ref":
        role_ref(args.cpu, plan)
        return 0
    if args.role == "mesh":
        role_mesh(shape, args.cpu, plan, args.keep_going)
        return 0
    if args.role == "dryrun":
        role_dryrun(args.arch, shape, args.cpu, args.fake_device)
        return 0
    if args.role == "dryrun_decode":
        role_dryrun_decode(args.arch, shape, args.cpu, args.fake_device)
        return 0
    return lead(args.cpu, plan, ["--part", args.part]
                + (["--meshes", args.meshes] if args.meshes else [])
                + (["--one-card"] if args.one_card else [])
                + (["--keep-going"] if args.keep_going else []))


def lead(cpu: bool, plan: Plan, passed: list) -> int:
    t_start = time.perf_counter()
    deadline = t_start + plan.deadline_s
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

    def dry_run(role, arch, m, name):
        return _start(["--role", role, "--arch", arch, "--mesh", _name(m),
                       *flag], cpu_env, stdout=subprocess.DEVNULL,
                      stderr=open(OUT / f"{name}.err", "w"))
    dry = {(arch, m): dry_run("dryrun", arch, m, f"dryrun_{arch}_{_name(m)}")
           for arch, meshes in plan.train for m in meshes}
    # a decode step also on a "cuda" fake mesh on the card host, whose
    # DTensor dispatches as on the cards (the CUDA build needs a card
    # visible; it launches nothing)
    fakes = ("cpu",) if cpu else ("cpu", "cuda")
    for arch, m in plan.decode_dryrun:
        for fake in fakes:
            name = _dry_name("dryrun_decode", arch, m, fake)
            dry["decode", arch, m, fake] = _start(
                ["--role", "dryrun_decode", "--arch", arch, "--mesh",
                 _name(m), "--fake-device", fake, *flag],
                cpu_env if fake == "cpu" else
                dict(env, CUDA_VISIBLE_DEVICES="0", OMP_NUM_THREADS="2"),
                stdout=subprocess.DEVNULL,
                stderr=open(OUT / f"{name}.err", "w"))
    failed = []
    t0 = time.perf_counter()
    rc = _wait(_start(["--role", "ref", *flag],
                      dict(env, CUDA_VISIBLE_DEVICES="0") if not cpu else env),
               plan.ref_s, "the one-card references", deadline)
    ref_s = time.perf_counter() - t0
    ref = _load(OUT / "ref.json")
    if rc != 0 or ref is None or ref["errors"]:
        failed.append("references")
    ref = ref or {"parity": {}, "train": {}, "grad": {}, "serve": {},
                  "errors": {}}
    _say("mesh_ref", card=card, rc=rc, s=ref_s, train={
        a: {k: v for k, v in r.items() if k != "losses"} | {
            "first_loss": r["losses"][0], "last_loss": r["losses"][-1]}
        for a, r in ref["train"].items()}, grad=ref["grad"],
        errors=ref["errors"],
        serve={a: {k: v for k, v in r.items() if k != "fp32_tokens"}
               for a, r in ref["serve"].items()})
    runs = {}
    for m in plan.meshes:
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(plan.cards),
               str(Path(__file__).resolve()), "--role", "mesh", "--mesh",
               _name(m), *flag]
        rc = _wait(subprocess.Popen(cmd, env=env, cwd=ROOT,
                                    start_new_session=True), plan.run_s,
                   f"the {_name(m)} run", deadline)
        runs[m] = [_load(OUT / f"mesh_{_name(m)}_rank{r}.json") or {}
                   for r in range(plan.cards)]
        _say("mesh_run", mesh=list(m), rc=rc, s=time.perf_counter() - t0)
        if rc != 0:
            failed.append(f"run {_name(m)}")
    failed += report(runs, ref, plan, card)
    for key, p in dry.items():
        _wait(p, plan.run_s, f"the dry run {key}", deadline)
    failed += report_dryrun(runs, plan, cpu, card)
    launches = {k: sum(r.get("launches", {}).get(k, 0) for ranks in
                       runs.values() for r in ranks) for k in cs.COUNTED}
    _say("mesh_done", card=card, failed=failed, launches_across_cards=launches,
         launches_by_mesh_and_rank={_name(m): [r.get("launches") for r in
                                               ranks]
                                    for m, ranks in runs.items()},
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


def _exact(got, card) -> bool:
    """Each rank's kernel launches what its phase wanted (on the CPU,
    where the wrappers launch nothing, nothing is held)."""
    return card is None or all(g["launches"] == g["launches_want"]
                               for g in got)


def report(runs, ref, plan: Plan, card) -> list:
    """One line a phase and mesh; -> the names of the gates that failed."""
    failed = []
    for m, ranks in runs.items():
        for arch in plan.parity:
            got, err = _phase(ranks, f"parity {arch}")
            r0 = got[0] or {}
            want = ref["parity"].get(arch, {}).get("launches")
            ok = err is None and r0.get("held") is True and all(
                g["losses"] == r0["losses"] and g["launches"] == want
                for g in got)
            _say("mesh_parity", card=card, arch=arch, mesh=list(m),
                 layers=PARITY_LAYERS[arch], steps=PARITY_STEPS,
                 dtype="float32", rtol=PARITY_RTOL, held=ok, error=err, **{
                     k: r0.get(k) for k in ("loss_rel_max",
                                            "params_over_slack_max",
                                            "params_worst", "lr_sum",
                                            "losses")},
                 ref_losses=ref["parity"].get(arch, {}).get("losses"),
                 launches_by_rank=[(g or {}).get("launches") for g in got],
                 one_card_launches=want,
                 groups_by_rank=[(g or {}).get("groups") for g in got])
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
                    and all(g["losses"] == losses for g in got) \
                    and _exact(got, card)
                line = dict(
                    losses=losses, first_loss_rel=first, layers=r0["layers"],
                    step_s=r0["step_s"], tokens_per_s=r0["tokens_per_s"],
                    peak_gb_by_rank=[g["peak_gb"] for g in got],
                    step_peak_gb_by_rank=[g["step_peak_gb"] for g in got],
                    launches_by_rank=[g["launches"] for g in got],
                    launches_exact=_exact(got, card),
                    groups_by_rank=[g["groups"] for g in got],
                    device_ms_by_group=r0["device_ms_by_group"],
                    one_card={k: one[k] for k in (
                        "step_s", "tokens_per_s", "peak_gb", "step_peak_gb",
                        "launches", "device_ms_by_group")},
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
        for arch, meshes in plan.grad:
            if m not in meshes:
                continue
            got, err = _phase(ranks, f"grad {arch}")
            one = ref["grad"].get(arch)
            ok = err is None and one is not None
            line = {}
            if ok:
                r0 = got[0]
                rel = {k: abs(r0[k] - one[k]) / abs(one[k])
                       for k in ("loss", "grad_norm")}
                ok = max(rel.values()) <= cs.TRAIN_RTOL and all(
                    math.isfinite(r0[k]) for k in rel) and all(
                    (g["loss"], g["grad_norm"]) ==
                    (r0["loss"], r0["grad_norm"]) for g in got) \
                    and _exact(got, card)
                line = dict(rel=rel, rtol=cs.TRAIN_RTOL,
                            **{k: r0[k] for k in ("loss", "grad_norm",
                                                  "seconds", "batch")},
                            peak_gb_by_rank=[g["peak_gb"] for g in got],
                            launches_by_rank=[g["launches"] for g in got],
                            launches_exact=_exact(got, card), one_card=one,
                            phase_s=r0["phase_s"])
            _say("mesh_grad", card=card, arch=arch, mesh=list(m), held=ok,
                 error=err, **line)
            if not ok:
                failed.append(f"grad {arch} {_name(m)}")
        for arch, meshes in plan.serve:
            if m not in meshes:
                continue
            got, err = _phase(ranks, f"serve {arch}")
            one = ref["serve"].get(arch, {})
            want = one.get("fp32_tokens")
            # a mamba decode step's collectives on (1, 4), from each rank's
            # trace, as the dry run counts them (mamba_decode_collectives)
            coll_ok = err is None and (m != (1, 4) or all(
                g["collectives_want"] is None
                or g["collectives"] == g["collectives_want"] for g in got))
            ok = err is None and want is not None and all(
                g["fp32_tokens"] == want for g in got) and \
                _exact(got, card) and coll_ok
            r0 = got[0] or {}
            _say("mesh_serve", card=card, arch=arch, mesh=list(m), held=ok,
                 error=err, layers=r0.get("layers"),
                 fp32_tokens_equal=err is None and want is not None and all(
                     g["fp32_tokens"] == want for g in got),
                 tokens_per_s=r0.get("tokens_per_s"),
                 decode_step=r0.get("decode_step"),
                 one_card={k: one.get(k) for k in (
                     "tokens_per_s", "decode_step", "launches")},
                 launches_by_rank=[(g or {}).get("launches") for g in got],
                 launches_exact=err is None and _exact(got, card),
                 collectives_by_rank=[(g or {}).get("collectives")
                                      for g in got],
                 collectives_want=r0.get("collectives_want"),
                 collectives_held=coll_ok)
            if not ok:
                failed.append(f"serve {arch} {_name(m)}")
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
                    lookup=pred["lookup"],
                    step_s=got[0]["step_s"],
                    bound_over_step=pred["bound_s"] / got[0]["step_s"],
                    trace_s=pred["trace_s"])
            _say("mesh_dryrun", card=card, arch=arch, mesh=list(m), held=ok,
                 error=err, **line)
            if not ok:
                failed.append(f"dryrun {arch} {_name(m)}")
    for arch, m in plan.decode_dryrun:
        for fake in ("cpu",) if cpu else ("cpu", "cuda"):
            name = _dry_name("dryrun_decode", arch, m, fake)
            pred = _load(OUT / f"{name}.json")
            if pred is None:
                err, line = (OUT / f"{name}.err").read_text()[-3000:], {}
            else:
                err = None
                by_T = list(pred["by_T"].values())
                want = pred["want"]
                # no collective of a decode step as large as one rank's
                # vocab shard of the embedding table; a mamba step's
                # collectives as mamba_decode_collectives counts them
                line = dict(layers=pred["layers"], by_T=pred["by_T"],
                            want=want, equal_collectives=all(
                                t["collective_by_kind"] ==
                                by_T[0]["collective_by_kind"] for t in by_T),
                            moves_no_table=all(
                                t["largest_collective"]
                                < t["lookup"]["table_shard_bytes"]
                                for t in by_T),
                            as_counted=want is None or all(
                                {k: t[k] for k in want} == want
                                for t in by_T))
            ok = err is None and line["equal_collectives"] and \
                line["moves_no_table"] and line["as_counted"]
            _say("mesh_dryrun", card=card, arch=arch, mesh=list(m),
                 step="decode", fake_device=fake, held=ok, error=err,
                 **line)
            if not ok:
                failed.append(f"dryrun decode {arch} {_name(m)} {fake}")
    return failed


if __name__ == "__main__":
    sys.exit(main())
