#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

Run from the root of a checkout:   python3 chip_smoke.py

It needs one CUDA device, nvcc (``CUDA_HOME`` or ``/usr/local/cuda``) and no
network.  Phases, one line of output each; any failure raises and the exit
code is not 0:

1. environment: the card's name and power limit, versions, TF32 off, the
   decode-attention and flash-attention kernels built from
   ``src/repro_torch/kernels`` (one nvcc each, started together), with
   ptxas's register and spill counts;
2. each kernel against its plain PyTorch version on the card, in fp32 and
   bf16.  Decode attention: the shapes of the JAX package's decode-attention
   sweep, full gemma-2b widths (B=4, H=8, Hkv=1, D=256) at the served cache
   (T=64, the positions where the split plan changes) and at T=4096
   including a ring buffer past T, and other configs' widths and edge cases
   of head grouping and D.  Flash attention: the JAX flash sweep's shapes,
   gemma-2b's training shape (B=4, S=1024, H=8, Hkv=1, D=256), ragged S,
   starcoder2's and gemma3's sliding windows, D of 32, 40, 96 and 128, G of
   1, 2 and 8; and one gradient through its autograd function against plain
   autograd (a check of the function's wiring: its backward is the plain
   recompute);
3. serve: ``Server.generate`` on full-width gemma-2b (18 layers, bf16, random
   weights from a seeded generator): 32 prompt + 32 new tokens for a batch
   of 4, launched through the decode kernel once per layer and token; then
   the same 64 positions, on a cache of the served length, through the
   kernel and through the plain ``torch`` attention agree;
4. train: ``Trainer.run`` on full-width gemma-2b (bf16, remat "full"): 8
   steps of batch 4 x 1024 tokens streamed from a lake of synthetic
   documents through ``DeviceFeeder``, through the flash kernel twice per
   layer and step (forward, and again under remat in the backward); finite
   and falling loss; one checkpoint committed into the lake, which restores
   into an equal state; the loss and gradient norm of one batch through the
   kernel and through the plain ``torch`` attention agree;
5. resume: an injected ``HostFailure`` at step 5 of a smoke-config run on the
   card, and its resumption from the lake's checkpoint;
6. trace: where one full-width decode step and one full-width train step
   spend their time on the device (``torch.profiler``);
7. numbers: ``{"kernels": [...]}`` with each kernel's launches on its main
   path, its largest error, and its time beside its bound, the plain
   version's and one PyTorch call's, at the main path's shapes.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import resource
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.storage import MemoryProvider  # noqa: E402
from repro_torch.distributed import HostFailure  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref, ops as da_ops)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, ops as fa_ops, ref_attention)
from repro_torch.launch.serve import Server, ServeJob  # noqa: E402
from repro_torch.launch.steps import train_state_specs  # noqa: E402
from repro_torch.launch.train import Trainer, TrainJob  # noqa: E402
from repro_torch.models import abstract, build_model, named_leaves  # noqa: E402
from repro_torch.models.param import unflatten  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
DECODE_RTOL = 2e-2                                  # tests/test_models.py:83
TRAIN_RTOL = 2e-2                                   # tests/test_models.py:83
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM, fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM, bf16 tensor cores, dense
GEMMA = dict(B=4, H=8, Hkv=1, D=256)
# the train phase: full-width gemma-2b, 8 steps of 4 x 1024 lake-fed tokens
TRAIN_JOB = TrainJob(arch="gemma-2b", smoke=False, steps=8, global_batch=4,
                     seq_len=1024, warmup=2, num_docs=16, checkpoint_every=8,
                     log_every=1)

# the shapes of tests/test_kernels.py::test_decode_attention_sweep
SWEEP = [
    (2, 4, 2, 64, 512, 100, 0),
    (1, 8, 8, 128, 1024, 1023, 0),
    (2, 4, 1, 64, 256, 300, 256),
    (1, 2, 2, 32, 128, 0, 0),
]
# gemma-2b widths: the cache Server.generate serves in phase 3 (T=64; the
# plan goes from one split to two at pos 32), then a long cache
FULL = [(4, 8, 1, 256, 64, pos, 0) for pos in (0, 31, 32, 63)] + \
    [(4, 8, 1, 256, 4096, pos, 0) for pos in (0, 1000, 4095)] + \
    [(4, 8, 1, 256, 4096, 4096 + 500, 4096)]          # ring buffer, pos > T
# other configs' widths and the kernel's edge cases: phi-3-vision's D=96;
# qwen2-72b's G=8; gemma3-27b's G=2, D=128; G=12 (two head groups) with D=40
# (5 chunks of 8); G=3 with D=8 and a ring buffer; ragged T everywhere
OTHER = [(2, 32, 32, 96, 300, 299, 0), (1, 64, 8, 128, 2048, 1500, 0),
         (2, 32, 16, 128, 1000, 999, 0), (1, 12, 1, 40, 77, 50, 0),
         (3, 6, 2, 8, 33, 100, 33)]

# flash attention (B, S, H, Hkv, D, window): the shapes of
# tests/test_kernels.py::test_flash_attention_sweep (G = 2, 8, 1, 3)
FLASH_SWEEP = [(2, 256, 4, 2, 64, 0), (1, 512, 8, 1, 128, 0),
               (2, 256, 4, 4, 64, 96), (1, 384, 6, 2, 32, 0)]
# gemma-2b's training shape, then ragged S at gemma's widths
FLASH_GEMMA = [(4, 1024, 8, 1, 256, 0), (1, 1000, 8, 1, 256, 0),
               (2, 77, 8, 1, 256, 0)]
# starcoder2-3b's window 4096 past it (H=24, Hkv=2, D=128); gemma3-27b's
# local layers (window 1024, G=2, D=128); phi-3-vision's D=96 (G=1); D=40
# with a ragged S; D=32 and G=8 with a window shorter than a tile
FLASH_OTHER = [(1, 5000, 24, 2, 128, 4096), (1, 2048, 32, 16, 128, 1024),
               (2, 500, 32, 32, 96, 0), (1, 300, 4, 1, 40, 0),
               (2, 333, 16, 2, 32, 20)]


def _say(tag: str, **fields) -> None:
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _inputs(B, H, Hkv, D, T, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype)
            for shape in ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]


# ----------------------------------------------------------------- phase 1
def environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"decode_attention": da_ops, "flash_attention": fa_ops}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:   # one nvcc each, together
        for built in [pool.submit(ops.build) for ops in kernels.values()]:
            built.result()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, ops in kernels.items():
        log = ops.library_path().with_suffix(".log")   # written by the build
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln]
    print(smi)
    _say("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), kernel_build_s=build_s,
         ptxas=ptxas)
    return smi


# ----------------------------------------------------------------- phase 2
def kernel_vs_plain():
    """Each case against the plain version twice.  In the dtype of the inputs
    at ``TOL`` (absolute plus relative).  And, since the kernel computes in
    fp32 and rounds only its output, against the plain version in fp32 on the
    same inputs: within half an ulp of the output dtype (2**-8 of the value
    in bf16, nothing in fp32) plus the fp32 ``TOL``."""
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
        for B, H, Hkv, D, T, pos, window in SWEEP + FULL + OTHER:
            q, k, v = _inputs(B, H, Hkv, D, T, dtype)
            got = decode_attention(q, k, v, pos=pos, window=window)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, pos=pos, window=window).float()
            want32 = decode_attention_ref(q.float(), k.float(), v.float(),
                                          pos=pos, window=window)
            diff = (got.float() - want).abs()
            diff32 = (got.float() - want32).abs()
            name = (f"{str(dtype)[6:]} B{B} H{H} Hkv{Hkv} D{D} T{T} pos{pos}"
                    f" w{window}")
            errors[name] = diff.max().item()
            ok = (bool((diff <= TOL[dtype] + TOL[dtype] * want.abs()).all())
                  and bool((diff32 <= TOL[torch.float32]
                            + half_ulp * want32.abs()).all())
                  and bool(torch.isfinite(got).all()))
            if not ok:
                raise AssertionError(
                    f"kernel disagrees with plain at {name}: max|err| "
                    f"{errors[name]}, against fp32 {diff32.max().item()}")
    _say("kernel_vs_plain", cases=len(errors), max_abs_err=max(errors.values()),
         errors=errors)
    return errors


def _flash_inputs(B, S, H, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype)
            for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def flash_vs_plain():
    """The flash kernel against its plain version, with the same two gates as
    ``kernel_vs_plain``; then one gradient through its autograd function
    against plain autograd.  The backward recomputes through the plain
    version, as in JAX, so that check covers only the autograd function's
    wiring; the train phase's loss and gradient norm through the kernel and
    through plain attention are where the kernel's output reaches the
    gradients."""
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
        for B, S, H, Hkv, D, window in FLASH_SWEEP + FLASH_GEMMA + FLASH_OTHER:
            q, k, v = _flash_inputs(B, S, H, Hkv, D, dtype)
            got = flash_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            want = ref_attention(q, k, v, window=window).float()
            want32 = ref_attention(q.float(), k.float(), v.float(),
                                   window=window)
            diff = (got.float() - want).abs()
            diff32 = (got.float() - want32).abs()
            name = f"{str(dtype)[6:]} B{B} S{S} H{H} Hkv{Hkv} D{D} w{window}"
            errors[name] = diff.max().item()
            ok = (bool((diff <= TOL[dtype] + TOL[dtype] * want.abs()).all())
                  and bool((diff32 <= TOL[torch.float32]
                            + half_ulp * want32.abs()).all())
                  and bool(torch.isfinite(got).all()))
            if not ok:
                raise AssertionError(
                    f"flash kernel disagrees with plain at {name}: max|err| "
                    f"{errors[name]}, against fp32 {diff32.max().item()}")
            del q, k, v, got, want, want32, diff, diff32
    q, k, v = (t.requires_grad_() for t in
               _flash_inputs(4, 1024, 8, 1, 256, torch.bfloat16, seed=1))
    g = torch.randn(q.shape, device="cuda", dtype=q.dtype,
                    generator=torch.Generator("cuda").manual_seed(2))
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(ref_attention(q, k, v), (q, k, v), g)
    grad_err = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(got, want))
    tol = TOL[torch.bfloat16]
    if not all(bool(((a.float() - b.float()).abs()
                     <= tol + tol * b.float().abs()).all())
               for a, b in zip(got, want)):
        raise AssertionError(f"flash gradient differs from plain: {grad_err}")
    _say("flash_vs_plain", cases=len(errors), max_abs_err=max(errors.values()),
         grad_max_abs_err=grad_err, errors=errors)
    return errors


# ----------------------------------------------------------------- phase 3
def serve(card: str):
    job = ServeJob(arch="gemma-2b", smoke=False, batch=4, prompt_len=32,
                   max_new_tokens=32)
    torch.cuda.reset_peak_memory_stats()
    srv = Server(job)
    cfg = srv.cfg
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (job.batch, job.prompt_len)).astype(np.int32)
    total = job.prompt_len + job.max_new_tokens

    decode_attention.launches = 0
    out = srv.generate(prompts)
    launches = decode_attention.launches

    if out.shape != (job.batch, total):
        raise AssertionError(f"output shape {out.shape}")
    if not (out[:, :job.prompt_len] == prompts).all():
        raise AssertionError("prompt not preserved")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("token id out of vocab")
    if launches != cfg.num_layers * total:
        raise AssertionError(f"kernel launched {launches} times, want "
                             f"{cfg.num_layers} x {total}")
    first = dict(srv.stats, tokens_per_s=srv.throughput())

    again = Server(job)
    out2 = again.generate(prompts)
    if not np.array_equal(out, out2):
        raise AssertionError("a second Server gave other greedy tokens")
    second = dict(again.stats, tokens_per_s=again.throughput())
    del again

    # the served tokens at the served positions, on a cache of the served
    # length, through the kernel and through plain torch attention
    steps = total
    logits = {}
    with torch.inference_mode():
        for impl in ("torch", "kernel"):
            model = build_model(cfg, attn_impl=impl)
            cache = model.init_cache(job.batch, total, srv.device)
            per_step = []
            for t in range(steps):
                tok = torch.from_numpy(out[:, t]).to(srv.device, torch.int64)
                lg, cache = model.decode_step(srv.params, cache, tok, t,
                                              head=srv.head)
                per_step.append(lg.float())
            logits[impl] = torch.stack(per_step)
    if not torch.isfinite(logits["kernel"]).all():
        raise AssertionError("non-finite logits")
    rel = max(((logits["kernel"][t] - logits["torch"][t]).abs().max()
               / logits["torch"][t].abs().max()).item() for t in range(steps))
    if not rel < DECODE_RTOL:
        raise AssertionError(f"kernel vs torch attention: {rel} >= {DECODE_RTOL}")
    _say("serve", card=card, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, batch=job.batch, prompt_len=job.prompt_len,
         new_tokens=job.max_new_tokens, launches=launches,
         first_server=first, second_server=second,
         kernel_vs_torch_rel=rel, kernel_vs_torch_steps=steps,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         sample=out[0, job.prompt_len:job.prompt_len + 8].tolist())
    return srv, launches


# ----------------------------------------------------------------- phase 4
class _TimedCheckpoints(CheckpointManager):
    """The trainer's checkpoint manager, timing the copy of the state to the
    host (in ``save``) and the write and commit into the lake."""
    copy_s = write_s = 0.0

    def save(self, state, step, **kw):
        t0 = time.perf_counter()
        super().save(state, step, **kw)
        self.copy_s = time.perf_counter() - t0

    def _write(self, leaves, step):
        t0 = time.perf_counter()
        super()._write(leaves, step)
        self.write_s = time.perf_counter() - t0


def loss_and_grad_norm(model, params, batch):
    paths, leaves = zip(*named_leaves(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, _ = model.loss_fn(unflatten(zip(paths, leaves)), batch)
    grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    return loss.item(), norm.item()


def train(card: str):
    job = TRAIN_JOB
    torch.cuda.reset_peak_memory_stats()
    ckpt = _TimedCheckpoints(MemoryProvider(), keep=job.keep_checkpoints)
    trainer = Trainer(job, ckpt=ckpt)
    cfg = trainer.cfg

    flash_attention.launches = 0
    out = trainer.run(restore=False)
    launches = flash_attention.launches

    losses = [h["loss"] for h in out["history"]]
    if len(losses) != job.steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = (2 if cfg.remat == "full" else 1) * cfg.num_layers * job.steps
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times, want "
                             f"{want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = out["state"]
    if ckpt.saved_steps != [job.steps]:
        raise AssertionError(f"checkpoints {ckpt.saved_steps}")
    host_peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    t0 = time.perf_counter()
    back = ckpt.restore(abstract(train_state_specs(trainer.model,
                                                   trainer.opt)),
                        device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    mine, theirs = dict(named_leaves(state)), dict(named_leaves(back))
    if mine.keys() != theirs.keys() or not all(
            mine[k].dtype == theirs[k].dtype and torch.equal(mine[k], theirs[k])
            for k in mine):
        raise AssertionError("the restored checkpoint differs from the state")
    del back, mine, theirs
    state_gb = sum(t.numel() * t.element_size()
                   for _, t in named_leaves(state)) / 1e9

    # one batch, the trained params: kernel and plain attention agree
    batch = next(trainer._batches())
    compare = {impl: loss_and_grad_norm(build_model(cfg, attn_impl=impl),
                                        state["params"], batch)
               for impl in ("kernel", "torch")}
    rel = {name: abs(compare["kernel"][i] - compare["torch"][i])
           / abs(compare["torch"][i]) for i, name in enumerate(("loss",
                                                                "grad_norm"))}
    if not max(rel.values()) < TRAIN_RTOL:
        raise AssertionError(f"kernel vs torch attention: {compare}")

    step_s = statistics.median(h["sec"] for h in out["history"][1:])
    tokens = job.global_batch * job.seq_len
    _say("train", card=card, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, remat=cfg.remat,
         batch=job.global_batch, seq_len=job.seq_len, steps=job.steps,
         warmup=job.warmup, lr=job.lr, launches=launches,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         step_s=[h["sec"] for h in out["history"]], median_step_s=step_s,
         tokens_per_s=tokens / step_s, peak_memory_gb=peak_gb,
         state_gb=state_gb, save_s=ckpt.copy_s + ckpt.write_s,
         save_copy_s=ckpt.copy_s, save_write_s=ckpt.write_s,
         restore_s=restore_s, host_peak_gb=host_peak_gb,
         kernel_vs_torch=compare, kernel_vs_torch_rel=rel)
    return trainer, state, batch, launches


# ----------------------------------------------------------------- phase 5
def resume(card: str):
    """tests/test_torch_trainer.py::test_trainer_restores_after_failure, on
    the card."""
    job = TrainJob(arch="gemma-2b", steps=10, global_batch=4, seq_len=64,
                   checkpoint_every=2, num_docs=16, fail_at=(5,),
                   log_every=100)
    ckpt = CheckpointManager(MemoryProvider(), keep=3)
    first = Trainer(job, ckpt=ckpt)
    try:
        first.run(restore=False)
        raise AssertionError("the injected HostFailure did not fire")
    except HostFailure:
        pass
    saved = ckpt.latest_step()
    if saved is None or saved < 4:
        raise AssertionError(f"latest checkpoint {saved}")
    again = Trainer(dataclasses.replace(job, fail_at=()), ckpt=ckpt,
                    data_ds=first.data_ds)
    out = again.run(restore=True)
    resumed = out["history"][0]["step"]
    if out["final_step"] != 10 or resumed < 4 or \
            not math.isfinite(out["final_loss"]):
        raise AssertionError(f"resumed at {resumed}, ended at "
                             f"{out['final_step']}, loss {out['final_loss']}")
    _say("resume", card=card, failed_at=5, latest_checkpoint=saved,
         resumed_at=resumed, final_step=out["final_step"],
         final_loss=out["final_loss"])


# ----------------------------------------------------------------- phase 6
def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    replayed ``replays`` times between two events, so that the host's time to
    issue a call is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def call_ms(fn, calls: int = 100) -> float:
    """Time of one call issued from Python, as the serving loop issues it."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def kernel_times(fn, calls: int, top: int = 8):
    """Per call: wall time without the profiler, and by kernel name from
    ``torch.profiler``: device ms per launch and launches per call.  The
    profiler may miss a launch; a kind whose count is not a multiple of
    ``calls`` is flagged ``irregular`` and its launches per call rounded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.is_user_annotation:
            per_launch = e.self_device_time_total / 1e3 / e.count
            per_call = max(1, round(e.count / calls))
            kernels[e.key[:100]] = {"ms_per_launch": per_launch,
                                    "launches_per_call": per_call,
                                    "ms_per_call": per_launch * per_call,
                                    "irregular": e.count % calls != 0}
    busy = sum(k["ms_per_call"] for k in kernels.values())
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1]["ms_per_call"])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if kernels else None,
            "kernels_by_time": dict(by_time[:top]),
            "kernel_kinds": len(kernels)}


def trace_train(trainer, state, batch, card: str):
    """Where one full-width train step spends its time (it trains on)."""
    step = kernel_times(lambda: trainer.step_fn(state, batch), calls=2, top=16)
    _say("trace_train", card=card, arch=trainer.cfg.name,
         batch=list(batch["tokens"].shape), train_step=step)


def trace(srv, card: str):
    """Where one full-width decode step spends its time (batch 4, a 64-entry
    cache at its last position), and the kernel's two passes at a 32k cache."""
    cfg = srv.cfg
    cache = srv.model.init_cache(4, 64, srv.device)
    tok = torch.zeros(4, dtype=torch.int64, device=srv.device)
    with torch.inference_mode():
        step = kernel_times(lambda: srv.model.decode_step(
            srv.params, cache, tok, 63, head=srv.head), calls=8)
    q, k, v = _inputs(4, 8, 1, 256, 32768, torch.bfloat16, seed=5)
    attn = kernel_times(lambda: decode_attention(q, k, v, pos=32767), calls=20)
    _say("trace", card=card, arch=cfg.name, decode_step=step,
         decode_attention_32k=attn)


# ----------------------------------------------------------------- phase 7
def library_call(q, k, v, pos):
    """``scaled_dot_product_attention`` over the cache with a validity mask:
    the yardstick, never called by the port."""
    T = k.shape[1]
    q4 = q[:, :, None]                        # (B,H,1,D)
    k4, v4 = k.transpose(1, 2), v.transpose(1, 2)   # (B,Hkv,T,D)
    mask = (torch.arange(T, device=q.device) < min(pos + 1, T))[None, None, None]
    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                          enable_gqa=True)


def timings(T: int, pos: int, card: str):
    B, H, Hkv, D = GEMMA["B"], GEMMA["H"], GEMMA["Hkv"], GEMMA["D"]
    q, k, v = _inputs(B, H, Hkv, D, T, torch.bfloat16, seed=5)
    limit = min(pos + 1, T)
    nbytes = (2 * B * limit * Hkv * D + 2 * B * H * D) * 2
    ops = 4 * B * H * limit * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    lib = library_call(q, k, v, pos)
    ref = decode_attention_ref(q, k, v, pos=pos)
    lib_err = (lib[:, :, 0].float() - ref.float()).abs().max().item()
    return {
        "shape": f"B={B} H={H} Hkv={Hkv} D={D} T={T} pos={pos} bf16",
        "ms": device_ms(lambda: decode_attention(q, k, v, pos=pos)),
        "call_ms": call_ms(lambda: decode_attention(q, k, v, pos=pos)),
        "plain_ms": device_ms(lambda: decode_attention_ref(q, k, v, pos=pos)),
        "library_ms": device_ms(lambda: library_call(q, k, v, pos)),
        "library_max_abs_err": lib_err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "card": card,
    }


def flash_timings(B: int, S: int, card: str):
    """The flash kernel at gemma-2b's widths, causal, bf16."""
    H, Hkv, D = GEMMA["H"], GEMMA["Hkv"], GEMMA["D"]
    q, k, v = _flash_inputs(B, S, H, Hkv, D, torch.bfloat16, seed=5)
    pairs = S * (S + 1) // 2                    # causal (query, key) pairs
    ops = 4 * B * H * D * pairs                 # QK^T and PV, 2 each a pair
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))   # (B, heads, S, D)

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)
    lib_err = (library().transpose(1, 2).float()
               - ref_attention(q, k, v).float()).abs().max().item()
    return {
        "shape": f"B={B} S={S} H={H} Hkv={Hkv} D={D} causal bf16",
        "ms": device_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": device_ms(lambda: ref_attention(q, k, v), calls=5,
                              replays=4),
        "library_ms": device_ms(library),
        "library_max_abs_err": lib_err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "fp32_cores_ms": ops / FP32_OPS_PER_S * 1e3,
        "card": card,
    }


def main() -> None:
    card = environment()
    errors = kernel_vs_plain()
    flash_errors = flash_vs_plain()
    srv, launches = serve(card)
    trace(srv, card)
    del srv
    torch.cuda.empty_cache()
    trainer, state, batch, flash_launches = train(card)
    resume(card)
    trace_train(trainer, state, batch, card)
    del trainer, state, batch
    torch.cuda.empty_cache()
    serving = timings(64, 63, card)
    long = timings(32768, 32767, card)
    training = flash_timings(4, 1024, card)
    long_train = flash_timings(4, 4096, card)
    flash_entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:81",
        "launches": flash_launches,
        "max_abs_err": max(flash_errors.values()),
        **{k: training[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
        "training_shape": training,
        "long_shape": long_train,
    }
    entry = {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:65",
        "launches": launches,
        "max_abs_err": max(errors.values()),
        **{k: serving[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        "serving_shape": serving,
        "long_shape": long,
    }
    print(json.dumps({"kernels": [entry, flash_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
