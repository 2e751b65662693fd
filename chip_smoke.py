#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and image-feed paths on one
NVIDIA GPU and check them.

Run from the root of a checkout:   python3 chip_smoke.py

It needs one CUDA device, nvcc (``CUDA_HOME`` or ``/usr/local/cuda``) and no
network.  Phases, one line of output each; any failure raises and the exit
code is not 0:

1. environment: the card's name and power limit, versions, TF32 off, the
   decode-attention, flash-attention, ssd-scan and fused-preprocess kernels
   built from ``src/repro_torch/kernels`` (one nvcc each, started together),
   with ptxas's register and spill counts;
2. each kernel against its plain PyTorch version on the card, in fp32 and
   bf16.  Decode attention: the shapes of the JAX package's decode-attention
   sweep, full gemma-2b widths (B=4, H=8, Hkv=1, D=256) at the served cache
   (T=64, every position, so every one where the split plan changes), at
   T=4096 and at the timed T=32768, each with a ring buffer past T, and
   other configs' widths (granite's served cache among them) and edge cases
   of head grouping and D; the
   profiler's kernel names show each bf16 case on the tensor-core kernel,
   each fp32 case on the CUDA-core one, and a one-split case in one launch.
   Flash attention: the JAX flash sweep's shapes,
   gemma-2b's training shape (B=4, S=1024, H=8, Hkv=1, D=256), ragged S,
   starcoder2's and gemma3's sliding windows, D of 32, 40, 96 and 128, G of
   1, 2 and 8, zamba2's shared block (D=80), granite-moe-1b-a400m's training
   shape (B=4, S=1024, H=16, Hkv=8, D=64); the profiler's kernel names show
   each bf16 case on the tensor-core kernel and each fp32 case on the
   CUDA-core one; and one gradient through its autograd function against plain
   autograd (a check of the function's wiring: its backward is the plain
   recompute).  SSD scan: the JAX ssd sweep's shapes, a ragged chunk (Q =
   S = 200), a single chunk with G=4, widths its 16-byte copies cannot take
   (N of 12 and 4, P of 20 and 7), mamba2-1.3b's training shape (B=4,
   S=2048, nh=64, P=64, N=128, 8 chunks of 256), also fed as views of its
   conv output as ``mamba2_forward`` passes them, zamba2-2.7b's (nh=80,
   N=64) and a long sequence (B=1, S=32768), output and final state,
   against the per-token oracle up to S=1024 and ``ssd_chunked`` beyond; the
   profiler's kernel names show each bf16 case on the four tensor-core
   passes and each fp32 case on the CUDA-core kernel; and one gradient
   through its autograd function (wiring only, as for flash).  Fused
   preprocess (crop, cast, normalize): the JAX sweep's crops, the image
   feed's batch (256 x 250 x 250 x 3, centre 224, ImageNet's mean and std),
   one channel, 3.1 GB whose byte index passes 2**31, every source offset
   mod 16, an odd w*C, C of 4 and of 7 and 64 (above the kernel's table), one
   row and a row of 4350 elements, within 1e-6; and the inputs its wrapper
   must refuse;
2b. image feed: a lake of 2048 random 250 x 250 x 3 images, queried on the
   card with the torch TQL engine (a WHERE and its top-k form, each equal to
   the numpy engine's), streamed through the loader and ``DeviceFeeder`` as
   uint8 and crop-normalized by the kernel, one launch a batch of 256: the
   top-k view, then all 2048 images; each output against the plain version,
   the top-k batch against numpy on the host, exactly; the query times of
   both engines, images/s through the feed, the device's idle share, and the
   host-to-device ms of one batch as uint8 and as fp32; then the feed's
   split: the loader alone over the same lake, a batch's pinned copy and its
   host-to-device copy, and the kernel's device ms a batch from the feed's
   profile;
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
7. train mamba2: ``Trainer.run`` on full-width mamba2-1.3b (48 layers, bf16,
   remat "full"): 8 steps of batch 4 x 2048 streamed from a lake of
   documents whose tokens follow Zipf's law, through the ssd kernel twice
   per layer and step; finite and falling loss, one checkpoint that
   restores bit for bit, and the loss and gradient norm of one batch through
   the kernel and through plain ``ssd_chunked`` within 2e-2; then the trace
   of one of its train steps;
8. zamba2: the loss and gradients of one batch of 2 x 1024 tokens on
   full-width zamba2-2.7b (54 mamba layers, the shared attention block 9
   times, bf16, remat "full"), through the ssd and flash kernels (2 x 54 and
   2 x 9 launches) and through the plain impls, within 2e-2; each route
   timed four times, the first route alternating, beside the ssd and flash
   kernels' and their plain versions' device ms at this pass's shapes;
9. moe: one full-width granite-moe-1b-a400m MoE layer (32 experts, top-8,
   d 1024) at 4 x 1024 tokens in bf16 and fp32, its forward and backward
   under ``torch.cuda.set_sync_debug_mode("error")``; two more calls
   bit-equal; in fp32 equal to the CPU's call within 1e-4 of its largest
   output, with the same expert ids; the share of assignments dropped at
   capacity 1280, and the layer's ms beside its expert GEMMs';
10. train granite: ``Trainer.run`` on full-width granite-moe-1b-a400m (24
   layers, bf16, remat "full"): phase 4's gates (8 steps of 4 x 1024 from
   phase 7's lake of Zipf tokens, the flash kernel 2 x 24 times a step, a checkpoint restored bit for
   bit, kernel vs plain attention within 2e-2) and the batch's aux loss;
   then the trace of one step, with its device ms grouped by
   ``TRACE_GROUPS``;
11. serve ssm and moe: phase 3's ``serve`` on full-width mamba2-1.3b,
   zamba2-2.7b and granite-moe-1b-a400m: zamba2 through the decode kernel 9
   times a token (head dim 80), granite 24 times (head dim 64, G=2), each's
   decode logits through the kernel and plain attention within 2e-2 in fp32
   (and, reported, in bf16, where one expert choice flipped by rounding
   moves a logit more than attention's error); mamba2's decode logits at
   512 positions (two chunks) against the train forward's through the ssd
   kernel, within 2e-2 relative in fp32 (and, reported, in bf16; see
   ``scripts/ssm_bf16_drift.py`` for the JAX package's own bf16 drift);
12. numbers: ``{"kernels": [...]}`` with each kernel's launches on its main
   path, its largest error, and its time beside its bound, the plain
   version's and one PyTorch call's (none computes SSD, none crops and
   normalizes), at the main path's shapes (decode at gemma-2b's widths with
   T of 64, 1024, 4096 and 32768 and at zamba2's served shape, each also as
   the ms of one call issued from Python; flash also at zamba2's shared
   block, B=2 S=1024 H=Hkv=32 D=80, from phase 8; ssd at mamba2's, the long
   and zamba2's shapes, with the ms of a call, each pass's ms and the bf16
   route's own byte floor; preprocess at the feed's batch with it in L2 and
   over a rotation of 5 batches, the ms of a call, and the 3.1 GB case); a
   ``[bound]`` line for each timed shape with the bytes and operations its
   bound comes from; decode and flash also at granite's served and
   training shapes (H=16, Hkv=8, D=64); and the script's total time.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import re
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
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.dataset import Dataset  # noqa: E402
from repro_torch.core.storage import MemoryProvider  # noqa: E402
from repro_torch.core.tql import execute_query  # noqa: E402
from repro_torch.core.tql.executor import VectorEval  # noqa: E402
from repro_torch.core.views import DatasetView  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DeviceFeeder, build_image_dataset, build_token_dataset)
from repro_torch.distributed import HostFailure  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref, ops as da_ops)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, ops as fa_ops, ref_attention)
from repro_torch.kernels.fused_preprocess import (  # noqa: E402
    fused_preprocess, ops as fp_ops, ref_preprocess)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ops as ssd_ops, ref_ssd, ssd)
import repro_torch.launch.steps as steps_lib  # noqa: E402
import repro_torch.models.model as model_lib  # noqa: E402
from repro_torch.launch.serve import Server, ServeJob  # noqa: E402
from repro_torch.launch.steps import train_state_specs  # noqa: E402
from repro_torch.launch.train import Trainer, TrainJob  # noqa: E402
from repro_torch.models import abstract, build_model, named_leaves  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    materialize, torch_dtype, tree_map, unflatten)
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

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
# the mamba2 train phase: full-width mamba2-1.3b, 8 steps of 4 x 2048 tokens
MAMBA2_JOB = TrainJob(arch="mamba2-1.3b", smoke=False, steps=8,
                      global_batch=4, seq_len=2048, warmup=2, num_docs=16,
                      checkpoint_every=8, log_every=1)
# the granite phases: full-width granite-moe-1b-a400m, 8 steps of 4 x 1024
# lake-fed tokens, and one of its MoE layers at the same 4 x 1024 tokens
GRANITE = "granite-moe-1b-a400m"
GRANITE_JOB = TrainJob(arch=GRANITE, smoke=False, steps=8, global_batch=4,
                       seq_len=1024, warmup=2, num_docs=16, checkpoint_every=8,
                       log_every=1)
MOE_RTOL = 1e-4           # the [moe] phase: fp32 card against the CPU
# a token whose k-th and (k+1)-th router probabilities lie closer than this
# share of the k-th may choose another expert on another device: fp32
# rounding, not a fault; such tokens are counted and left out of the gate
MOE_NEAR_TIE = 1e-5
# each kernel's wrapper and its launch counter
COUNTED = {"decode_attention": decode_attention,
           "flash_attention": flash_attention, "ssd_scan": ssd,
           "fused_preprocess": fused_preprocess}

# the shapes of tests/test_kernels.py::test_decode_attention_sweep
SWEEP = [
    (2, 4, 2, 64, 512, 100, 0),
    (1, 8, 8, 128, 1024, 1023, 0),
    (2, 4, 1, 64, 256, 300, 256),
    (1, 2, 2, 32, 128, 0, 0),
]
# gemma-2b widths: the cache Server.generate serves in phase 3 (T=64) at
# every position, so at each one where the plan changes; then long caches,
# the timed 32k one and ring buffers past T
FULL = [(4, 8, 1, 256, 64, pos, 0) for pos in range(64)] + \
    [(4, 8, 1, 256, 4096, pos, 0) for pos in (0, 1000, 4095)] + \
    [(4, 8, 1, 256, 4096, 4096 + 500, 4096),           # ring buffer, pos > T
     (4, 8, 1, 256, 32768, 32767, 0),
     (4, 8, 1, 256, 32768, 32768 + 5000, 32768)]
# other configs' widths and the kernel's edge cases: phi-3-vision's D=96;
# qwen2-72b's G=8; gemma3-27b's G=2, D=128; G=12 (two head groups) with D=40
# (5 chunks of 8); G=3 with D=8 and a ring buffer; ragged T everywhere;
# zamba2's shared block and granite's attention (G=2, D=64) as served
OTHER = [(2, 32, 32, 96, 300, 299, 0), (1, 64, 8, 128, 2048, 1500, 0),
         (2, 32, 16, 128, 1000, 999, 0), (1, 12, 1, 40, 77, 50, 0),
         (3, 6, 2, 8, 33, 100, 33)] + \
    [(4, 32, 32, 80, 64, pos, 0) for pos in (0, 63)] + \
    [(4, 16, 8, 64, 64, pos, 0) for pos in (0, 1, 31, 32, 62, 63)]   # granite

# flash attention (B, S, H, Hkv, D, window): the shapes of
# tests/test_kernels.py::test_flash_attention_sweep (G = 2, 8, 1, 3)
FLASH_SWEEP = [(2, 256, 4, 2, 64, 0), (1, 512, 8, 1, 128, 0),
               (2, 256, 4, 4, 64, 96), (1, 384, 6, 2, 32, 0)]
# gemma-2b's training shape, then ragged S at gemma's widths
FLASH_GEMMA = [(4, 1024, 8, 1, 256, 0), (1, 1000, 8, 1, 256, 0),
               (2, 77, 8, 1, 256, 0)]
# starcoder2-3b's window 4096 past it (H=24, Hkv=2, D=128); gemma3-27b's
# local layers (window 1024, G=2, D=128); phi-3-vision's D=96 (G=1); D=40
# with a ragged S; D=32 and G=8 with a window shorter than a tile; zamba2's
# shared block at its train phase's shape (H=Hkv=32, D=80)
FLASH_OTHER = [(1, 5000, 24, 2, 128, 4096), (1, 2048, 32, 16, 128, 1024),
               (2, 500, 32, 32, 96, 0), (1, 300, 4, 1, 40, 0),
               (2, 333, 16, 2, 32, 20), (2, 1024, 32, 32, 80, 0)]
# granite-moe-1b-a400m's training shape (G=2, D=64)
FLASH_GRANITE = dict(B=4, S=1024, H=16, Hkv=8, D=64)

# the decode and flash kernels each input dtype runs, as the profiler names
# them (a decode call of more than one split also runs the combine)
DECODE_ROUTES = {torch.bfloat16: "decode_mma_kernel",
                 torch.float32: "decode_simt_kernel"}
DECODE_COMBINE = "decode_combine_kernel"
FLASH_ROUTES = {torch.bfloat16: "flash_fwd_mma_kernel",
                torch.float32: "flash_fwd_kernel"}
# the decode shapes timed (B, H, Hkv, D, T, pos): gemma-2b's widths at the
# served cache and longer ones, then zamba2-2.7b's shared block and
# granite-moe-1b-a400m's attention as served
DECODE_TIMED = [(4, 8, 1, 256, T, T - 1) for T in (64, 1024, 4096, 32768)] + \
    [(4, 32, 32, 80, 64, 63), (4, 16, 8, 64, 64, 63)]
# zamba2-2.7b's shared attention block at its train phase's shape
FLASH_ZAMBA2 = dict(B=2, S=1024, H=32, Hkv=32, D=80)
# the [zamba2] phase's rounds: which route goes first alternates, so that
# neither is always the one that runs on a cold allocator
ZAMBA2_ORDER = [("kernel", "torch"), ("torch", "kernel")] * 2

# the ssd scan (B, S, nh, P, G, N, Q): the shapes of
# tests/test_kernels.py::test_ssd_sweep (two chunks and more, one chunk, G=4)
SSD_SWEEP = [(2, 128, 4, 32, 1, 16, 32), (1, 256, 8, 64, 2, 32, 64),
             (2, 64, 2, 16, 1, 8, 64), (1, 96, 4, 32, 4, 16, 32)]
# mamba2-1.3b's training shape (8 chunks), zamba2-2.7b's widths (nh=80,
# N=64) at its phase's 2 x 1024, and a long sequence at mamba2's widths
SSD_MAMBA2 = (4, 2048, 64, 64, 1, 128, 256)
SSD_ZAMBA2 = (2, 1024, 80, 64, 1, 64, 256)
SSD_LONG = (1, 32768, 64, 64, 1, 128, 256)
# the bf16 route's edges: a ragged chunk (Q = S = 200, not a multiple of
# 16) with N=8 and P=16; S=96 with G=4 as a single chunk; widths its
# 16-byte copies cannot take (N=12, P=20; N=4 and an odd P=7 with chunks of
# 50)
SSD_EDGE = [(2, 200, 4, 16, 1, 8, 256), (1, 96, 4, 32, 4, 16, 256),
            (1, 128, 2, 20, 1, 12, 64), (1, 100, 3, 7, 1, 4, 50)]
# the kernels each input dtype runs, as the profiler names them: bf16 the
# four tensor-core passes, fp32 the CUDA-core kernel
SSD_ROUTES = {torch.bfloat16: ("ssd_chunk_state_kernel", "ssd_chunk_cb_kernel",
                               "ssd_state_pass_kernel",
                               "ssd_chunk_scan_kernel"),
              torch.float32: ("ssd_fwd_kernel",)}
SSD_REF_MAX_S = 1024      # the per-token oracle's loop is cheap up to here
PRE_ATOL = 1e-6                                      # tests/test_kernels.py
SWEEP_MEAN, SWEEP_STD = (0.48, 0.45, 0.41), (0.23, 0.22, 0.23)   # its sweep
# as published with torchvision's ImageNet models
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# the image feed: the paper's random dataset (250 x 250 x 3), batches of 256
# cropped to the centre 224
FEED_IMAGES, FEED_BATCH, FEED_CROP = 2048, 256, (13, 13, 224, 224)
FEED_WHERE = "SELECT * FROM dataset WHERE MEAN(images) > 127 AND labels != 1"
FEED_TOPK = FEED_WHERE + " ORDER BY MEAN(images) DESC LIMIT 256"
# (images, crop, mean, std): tests/test_kernels.py's fused-preprocess sweep,
# the feed's batch, one channel, and 3.1 GB whose byte index passes 2**31;
# then the kernel's edges: every source offset mod 16 (x0 of 0-15) with one
# channel and with three, on rows of odd length so that the offset also
# moves row by row and quads cross rows' ends; an odd w*C; C = 4 (the
# table's last width); one row; a row longer than a pass of a block (4350
# elements); and C of 7 and 64, above the table's limit (a division per
# element)
PRE_CASES = [((3, 64, 64, 3), crop, SWEEP_MEAN, SWEEP_STD)
             for crop in ((0, 0, 32, 32), (8, 16, 32, 32), (1, 1, 30, 30))] + [
    ((FEED_BATCH, 250, 250, 3), FEED_CROP, IMAGENET_MEAN, IMAGENET_STD),
    ((5, 97, 131, 1), (3, 7, 61, 89), (0.449,), (0.226,)),
    ((16384, 250, 250, 3), (200, 200, 50, 50), IMAGENET_MEAN, IMAGENET_STD)
] + [((7, 45, 45, 1), (1, x0, 40, 23), (0.449,), (0.226,))
     for x0 in range(16)] + [
    ((7, 41, 41, 3), (1, x0, 37, 21), IMAGENET_MEAN, IMAGENET_STD)
    for x0 in range(16)] + [
    ((9, 50, 50, 3), (2, 5, 41, 37), IMAGENET_MEAN, IMAGENET_STD),
    ((6, 64, 80, 4), (5, 3, 50, 61), IMAGENET_MEAN + (0.5,),
     IMAGENET_STD + (0.25,)),
    ((1, 5, 40, 3), (2, 4, 1, 30), IMAGENET_MEAN, IMAGENET_STD),
    ((3, 9, 1500, 3), (1, 1, 7, 1450), IMAGENET_MEAN, IMAGENET_STD),
    ((4, 33, 29, 7), (2, 1, 27, 23), tuple(0.1 * c for c in range(7)),
     tuple(0.2 + 0.05 * c for c in range(7))),
    ((2, 19, 21, 64), (1, 2, 15, 17), tuple(c / 64 for c in range(64)),
     tuple(0.1 + c / 128 for c in range(64)))]


def _say(tag: str, **fields) -> None:
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _attention_layers(cfg) -> int:
    """Attention layers a token passes: every layer of a dense model, none
    in mamba2, zamba2's shared block once per period."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.shared_attn_period
    return cfg.num_layers


def _reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def _check_counts(counts: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly as often as ``want`` says (0 if not
    named) on the path just driven."""
    full = {name: want.get(name, 0) for name in COUNTED}
    if counts != full:
        raise AssertionError(f"{what}: kernel launches {counts}, want {full}")


def _inputs(B, H, Hkv, D, T, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype)
            for shape in ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]


# ----------------------------------------------------------------- phase 1
def _ptxas(log: str) -> dict:
    """From a build's log: each kernel (its name and template arguments, from
    the mangled name) with ptxas's registers and spill stores."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, tmpl = _demangle(entry.group(1))
            args = (["bf16"] if "bfloat16" in tmpl else
                    ["f32"] if tmpl.startswith("If") else [])
            args += re.findall(r"L[ib](\d+)E", tmpl)
            name += f"<{','.join(args)}>" if args else ""
            out[name] = {}
        elif name in out:
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out[name]["spill_stores"] = int(spill.group(1))
            if regs:
                out[name]["registers"] = int(regs.group(1))
    return out


def _demangle(mangled: str):
    """The last of a mangled name's length-prefixed parts (namespaces come
    first), and the rest of the name up to its parameters (the template
    arguments, if any)."""
    i, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while (size := re.match(r"\d+", mangled[i:])) is not None:
        start = i + size.end()
        name, i = mangled[start:start + int(size.group())], \
            start + int(size.group())
    end = mangled.find("Ev", i)
    return name, mangled[i:end if end >= 0 else len(mangled)]


def environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"decode_attention": da_ops, "flash_attention": fa_ops,
               "ssd_scan": ssd_ops, "fused_preprocess": fp_ops}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:   # one nvcc each, together
        for built in [pool.submit(ops.build) for ops in kernels.values()]:
            built.result()
    build_s = time.perf_counter() - t0
    ptxas = {name: _ptxas(ops.library_path().with_suffix(".log").read_text())
             for name, ops in kernels.items()}   # the logs the builds wrote
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
    in bf16, nothing in fp32) plus the fp32 ``TOL``.  The profiler's kernel
    names show each bf16 case on the tensor-core kernel and each fp32 case
    on the CUDA-core one, and a case the plan gives one split in one launch,
    with no combine."""
    errors, routes, n_sm = {}, {}, torch.cuda.get_device_properties(0) \
        .multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
        route, ran = DECODE_ROUTES[dtype], set()
        for B, H, Hkv, D, T, pos, window in SWEEP + FULL + OTHER:
            q, k, v = _inputs(B, H, Hkv, D, T, dtype)
            got, names = _profiled(
                lambda: decode_attention(q, k, v, pos=pos, window=window),
                "decode_")
            name = (f"{str(dtype)[6:]} B{B} H{H} Hkv{Hkv} D{D} T{T} pos{pos}"
                    f" w{window}")
            cut = da_ops.plan(B, H, Hkv, D, min(pos + 1, T), n_sm, dtype)
            if not any(route in n for n in names) or not all(
                    route in n or DECODE_COMBINE in n for n in names) or (
                    cut.launches == 1 and len(names) != 1):
                raise AssertionError(f"decode at {name} ({cut}) ran {names}, "
                                     f"want {route}")
            ran.update(names)
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
            del q, k, v, got, want, want32, diff, diff32
        routes[str(dtype)[6:]] = sorted(ran)
    _say("kernel_vs_plain", cases=len(errors), max_abs_err=max(errors.values()),
         routes=routes, errors=errors)
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
    errors, routes = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
        route, ran = FLASH_ROUTES[dtype], set()
        for B, S, H, Hkv, D, window in FLASH_SWEEP + FLASH_GEMMA + FLASH_OTHER \
                + [tuple(FLASH_GRANITE.values()) + (0,)]:
            q, k, v = _flash_inputs(B, S, H, Hkv, D, dtype)
            got, names = _profiled(
                lambda: flash_attention(q, k, v, window=window), "flash_fwd")
            name = f"{str(dtype)[6:]} B{B} S{S} H{H} Hkv{Hkv} D{D} w{window}"
            # bf16 on the tensor cores, fp32 on the CUDA cores
            if not names or not all(route in n for n in names):
                raise AssertionError(f"flash at {name} ran {names}, want "
                                     f"{route}")
            ran.update(names)
            want = ref_attention(q, k, v, window=window).float()
            want32 = ref_attention(q.float(), k.float(), v.float(),
                                   window=window)
            diff = (got.float() - want).abs()
            diff32 = (got.float() - want32).abs()
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
        routes[str(dtype)[6:]] = sorted(ran)
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
         grad_max_abs_err=grad_err, routes=routes, errors=errors)
    return errors


def _profiled(fn, part: str, tries: int = 5, calls: int = 2):
    """``fn()`` and the names of the kernels it launched whose names hold
    ``part``, from ``torch.profiler``.  The profiler may drop a launch's
    record (one of 13 in one run; in another, every record of one call
    three times over), so each session makes ``calls`` calls, and a session
    in which it saw none is made again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                out = fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if part in e.key]
        if names:
            break
    return out, names


def _ssd_inputs(B, S, nh, P, G, N, dtype, seed=0):
    """tests/test_kernels.py::test_ssd_sweep's distributions, from numpy."""
    rng = np.random.default_rng(seed)

    def cuda(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda")
    x = cuda(rng.standard_normal((B, S, nh, P), dtype=np.float32) * 0.5)
    dt = cuda(rng.uniform(1e-3, 0.1, (B, S, nh)))
    A = cuda(-rng.uniform(0.5, 4.0, (nh,)))
    Bm = cuda(rng.standard_normal((B, S, G, N), dtype=np.float32) * 0.3)
    Cm = cuda(rng.standard_normal((B, S, G, N), dtype=np.float32) * 0.3)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _ssd_views(B, S, nh, P, G, N, dtype, seed=0):
    """``_ssd_inputs``' values with x, B and C as views of one (B, S, nh*P +
    2*G*N) tensor, the strides ``mamba2_forward`` passes (its conv output
    ``xbc``): only their last dimension is contiguous."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, nh, P, G, N, dtype, seed)
    xbc = torch.cat([t.reshape(B, S, -1) for t in (x, Bm, Cm)], dim=-1)
    d_in = nh * P
    views = (xbc[..., :d_in].reshape(B, S, nh, P),
             xbc[..., d_in:d_in + G * N].reshape(B, S, G, N),
             xbc[..., d_in + G * N:].reshape(B, S, G, N))
    if any(v.is_contiguous() or v.stride(1) != xbc.shape[-1] for v in views):
        raise AssertionError("the xbc slices are not strided views")
    return views[0], dt, A, views[1], views[2]


def _ssd_routes(fn, route, tries: int = 3):
    """``fn()`` and the ssd kernels it launched, by the profiler's names,
    from up to ``tries`` sessions until each kernel of ``route`` is seen (the
    profiler may drop a record)."""
    seen = set()
    for _ in range(tries):
        out, names = _profiled(fn, "ssd_")
        seen.update(names)
        if all(any(k in n for n in seen) for k in route):
            break
    return out, sorted(seen)


def ssd_vs_plain():
    """The ssd kernel against its plain version (the per-token oracle up to
    ``SSD_REF_MAX_S``, ``ssd_chunked`` beyond), with ``kernel_vs_plain``'s two
    gates on the output, and the final state (fp32 in both) within the fp32
    ``TOL`` of the plain version computed in fp32: the JAX sweep's shapes,
    the bf16 route's edges, mamba2's, zamba2's and the long shape, and
    mamba2's shape again fed as views of its conv output.  The profiler's
    kernel names show each bf16 case on the four tensor-core passes and each
    fp32 case on the CUDA-core kernel.  Then one gradient through its
    autograd function against plain autograd: its backward recomputes
    through ``ssd_chunked``, as in JAX, so that check covers the wiring only;
    the mamba2 and zamba2 phases' loss and gradient norm through the kernel
    and through ``ssd_chunked`` are where its output reaches the gradients."""
    errors, routes = {}, {}
    tol32 = TOL[torch.float32]
    cases = [(shape, _ssd_inputs) for shape in
             SSD_SWEEP + SSD_EDGE + [SSD_MAMBA2, SSD_ZAMBA2, SSD_LONG]]
    cases.append((SSD_MAMBA2, _ssd_views))
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
            route, ran = SSD_ROUTES[dtype], set()
            for (B, S, nh, P, G, N, Q), make in cases:
                x, dt, A, Bm, Cm = make(B, S, nh, P, G, N, dtype)
                (y, st), names = _ssd_routes(
                    lambda: ssd(x, dt, A, Bm, Cm, chunk=Q), route)
                name = (f"{str(dtype)[6:]} B{B} S{S} nh{nh} P{P} G{G} N{N} "
                        f"Q{min(Q, S)}"
                        + (" xbc views" if make is _ssd_views else ""))
                if not all(any(k in n for n in names) for k in route) or \
                        not all(any(k in n for k in route) for n in names):
                    raise AssertionError(f"ssd at {name} ran {names}, want "
                                         f"{route}")
                ran.update(names)
                plain = (ref_ssd if S <= SSD_REF_MAX_S
                         else functools.partial(ssd_chunked, chunk=Q))
                want32, st32 = plain(x.float(), dt, A, Bm.float(), Cm.float())
                want = (want32 if dtype == torch.float32
                        else plain(x, dt, A, Bm, Cm)[0].float())
                diff = (y.float() - want).abs()
                diff32 = (y.float() - want32).abs()
                dst = (st - st32).abs()
                errors[name] = diff.max().item()
                ok = (bool((diff <= TOL[dtype] + TOL[dtype] * want.abs()).all())
                      and bool((diff32 <= tol32
                                + half_ulp * want32.abs()).all())
                      and bool((dst <= tol32 + tol32 * st32.abs()).all())
                      and bool(torch.isfinite(y).all())
                      and st.dtype == torch.float32 and y.dtype == dtype)
                if not ok:
                    raise AssertionError(
                        f"ssd kernel disagrees with plain at {name}: max|err| "
                        f"{errors[name]}, against fp32 {diff32.max().item()}, "
                        f"state {dst.max().item()}")
                del x, dt, A, Bm, Cm, y, st, want, want32, st32, diff, diff32
                torch.cuda.empty_cache()
            routes[str(dtype)[6:]] = sorted(ran)
    inputs = [t.requires_grad_() for t in
              _ssd_inputs(1, 512, 64, 64, 1, 128, torch.bfloat16, seed=1)]
    gen = torch.Generator("cuda").manual_seed(2)
    gy = torch.randn(inputs[0].shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    gst = torch.randn((1, 64, 128, 64), device="cuda", generator=gen)
    got = torch.autograd.grad(ssd(*inputs, chunk=256), inputs, (gy, gst))
    want = torch.autograd.grad(ssd_chunked(*inputs, chunk=256), inputs,
                               (gy, gst))
    grad_err = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(got, want))
    tol = TOL[torch.bfloat16]
    if not all(bool(((a.float() - b.float()).abs()
                     <= tol + tol * b.float().abs()).all())
               for a, b in zip(got, want)):
        raise AssertionError(f"ssd gradient differs from plain: {grad_err}")
    _say("ssd_vs_plain", cases=len(errors), max_abs_err=max(errors.values()),
         grad_max_abs_err=grad_err, routes=routes, errors=errors)
    return errors



def _images(shape, seed=0):
    """Random uint8 images made on the card from a seeded generator."""
    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def preprocess_vs_plain():
    """The crop-normalize kernel against its plain version on the card, at
    ``PRE_ATOL``: ``PRE_CASES``, among them a batch of 3.1 GB whose flat byte
    index passes 2**31 (its window reaches the last byte).  Then what the
    wrapper must refuse on the card."""
    errors = {}
    for shape, crop, mean, std in PRE_CASES:
        x = _images(shape)
        got = fused_preprocess(x, crop, mean, std)
        torch.cuda.synchronize()
        want = ref_preprocess(x, crop, mean, std)
        name = f"{tuple(shape)} crop{tuple(crop)}"
        errors[name] = (got - want).abs().max().item()
        if not (got.dtype == torch.float32 and got.shape == want.shape
                and got.is_contiguous() and errors[name] <= PRE_ATOL):
            raise AssertionError(f"fused_preprocess disagrees with plain at "
                                 f"{name}: max|err| {errors[name]}")
        del x, got, want
        torch.cuda.empty_cache()
    x = _images((2, 64, 64, 3))
    wide = torch.zeros((1, 1, fp_ops.MAX_EXTENT, 1), dtype=torch.uint8,
                       device="cuda")          # a row of 2**29 elements
    bad_inputs = [(x[:, :, :, :2], (0, 0, 8, 8)), (x.float(), (0, 0, 8, 8)),
                  (x.permute(0, 2, 1, 3), (0, 0, 8, 8)),
                  (wide, (0, 0, 1, fp_ops.MAX_EXTENT))]
    refused = 0
    for bad, crop in bad_inputs:
        try:
            fused_preprocess(bad, crop, (0.5,) * bad.shape[3],
                             (0.25,) * bad.shape[3])
        except ValueError:
            refused += 1
    del wide
    if refused != len(bad_inputs):
        raise AssertionError(f"the wrapper took {len(bad_inputs) - refused} "
                             f"of {len(bad_inputs)} bad inputs")
    _say("preprocess_vs_plain", cases=len(errors),
         max_abs_err=max(errors.values()), atol=PRE_ATOL, errors=errors)
    return errors


# ---------------------------------------------------------- image feed
def _device_busy_ms(prof) -> float:
    """Device time of every kernel and copy a profile recorded."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def _h2d_ms(host: np.ndarray, copies: int = 5) -> float:
    """ms of one pinned host-to-device copy of ``host``."""
    pinned = torch.from_numpy(host).pin_memory()
    pinned.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(copies):
        pinned.to("cuda", non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / copies


def _pin_ms(batch: dict, copies: int = 5) -> float:
    """ms of the pinned host copies ``DeviceFeeder`` makes of one batch."""
    t0 = time.perf_counter()
    for _ in range(copies):
        {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
         for k, v in batch.items()}
    return (time.perf_counter() - t0) / copies * 1e3


def _loader(view):
    """The view's loader as the image feed reads it."""
    return view.dataloader(tensors=["images", "labels"],
                           batch_size=FEED_BATCH, shuffle=False,
                           drop_last=True, num_workers=8)


def _feed(view, batches: list):
    """The image path's tail: the view's loader, ``DeviceFeeder`` onto the
    card, ``fused_preprocess``; appends (uint8 batch, output) to
    ``batches``."""
    for batch in DeviceFeeder(iter(_loader(view)), "cuda"):
        images = batch["images"]
        if images.dtype != torch.uint8 or images.device.type != "cuda":
            raise AssertionError(f"fed {images.dtype} on {images.device}")
        batches.append((images, batch["labels"],
                        fused_preprocess(images, FEED_CROP, IMAGENET_MEAN,
                                         IMAGENET_STD)))


def image_feed(card: str):
    """The query-to-device image path at the size users run: a lake of 2048
    random images of 250 x 250 x 3 (``build_image_dataset``, quant8), queried
    with the torch engine on the card (a WHERE, then its top-k form), each
    view equal to the numpy engine's; the top-k view and then the whole lake
    streamed through the loader and ``DeviceFeeder`` as uint8 and
    crop-normalized on the card, one kernel launch a batch.  Each output
    against the plain version on the card; the top-k batch also against a
    crop and normalize in numpy on the host of the rows the numpy engine
    chose."""
    t0 = time.perf_counter()
    ds = build_image_dataset(Dataset(MemoryProvider()),
                             num_images=FEED_IMAGES)
    build_s = time.perf_counter() - t0
    evals = []
    inner = VectorEval.eval

    def counted(self, node):          # which device each evaluation ran on
        evals.append(self.xp.device.type if self.engine == "torch"
                     else self.engine)
        return inner(self, node)
    VectorEval.eval = counted
    query_ms, views = {}, {}
    try:
        _reset_counts()
        for name, q in (("where", FEED_WHERE), ("topk", FEED_TOPK)):
            execute_query(ds, q, engine="numpy")          # warm the caches
            for engine in ("numpy", "torch"):
                del evals[:]
                t0 = time.perf_counter()
                views[name, engine] = execute_query(ds, q, engine=engine)
                query_ms[f"{name}_{engine}"] = (time.perf_counter() - t0) * 1e3
                if engine == "torch" and (not evals or set(evals) != {"cuda"}):
                    raise AssertionError(f"{name}: evaluations on {evals}")
            want = views[name, "numpy"].indices
            if not np.array_equal(views[name, "torch"].indices, want):
                raise AssertionError(f"{name}: the torch engine selects other "
                                     f"rows than the numpy engine")
    finally:
        VectorEval.eval = inner
    topk = views["topk", "torch"]
    if len(topk) != FEED_BATCH:
        raise AssertionError(f"top-k view of {len(topk)} rows")
    top_batches, all_batches = [], []
    _feed(topk, top_batches)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _feed(DatasetView.full(ds), all_batches)
        torch.cuda.synchronize()
        feed_s = time.perf_counter() - t0
    counts = _counts()
    _check_counts(counts, {"fused_preprocess": 1 + FEED_IMAGES // FEED_BATCH},
                  "image feed")
    busy_ms = _device_busy_ms(prof)
    kernel = [(e.self_device_time_total, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "fused_preprocess_kernel" in e.key]
    # the split: the loader alone over the same lake (no feeder, no card)
    t0 = time.perf_counter()
    host_batches = 0
    for host_batch in _loader(DatasetView.full(ds)):
        host_batches += 1
    loader_s = time.perf_counter() - t0

    errors = []
    for images, _, out in top_batches + all_batches:
        want = ref_preprocess(images, FEED_CROP, IMAGENET_MEAN, IMAGENET_STD)
        errors.append((out - want).abs().max().item())
    if len(all_batches) != FEED_IMAGES // FEED_BATCH or \
            max(errors) > PRE_ATOL:
        raise AssertionError(f"{len(all_batches)} batches, errors {errors}")
    rows = views["topk", "numpy"].indices
    y0, x0, h, w = FEED_CROP
    host = np.stack([np.asarray(ds.images[int(i)]) for i in rows])
    host_out = ((host[:, y0:y0 + h, x0:x0 + w].astype(np.float32)
                 / np.float32(255.0) - np.float32(IMAGENET_MEAN))
                / np.float32(IMAGENET_STD))
    _, labels, out = top_batches[0]
    host_err = float(np.abs(out.cpu().numpy() - host_out).max())
    if host_err != 0 or not np.array_equal(
            labels.cpu().numpy(), np.asarray(ds.labels.numpy())[rows]):
        raise AssertionError(f"the top-k batch differs from the host's crop "
                             f"of the numpy engine's rows: {host_err}")
    h2d = {"uint8_ms": _h2d_ms(host),
           "float32_ms": _h2d_ms(host.astype(np.float32)),
           "batch": list(host.shape)}
    _say("image_feed", card=card, images=FEED_IMAGES, size=[250, 250, 3],
         build_s=build_s,
         rows={f"{n}_{e}": len(v) for (n, e), v in views.items()},
         query_ms=query_ms, topk_plan=topk.topk_plan, launches=counts,
         max_abs_err=max(errors), host_max_abs_err=host_err)
    _say("image_feed_rate", card=card, batch=FEED_BATCH, crop=list(FEED_CROP),
         feed_s=feed_s, images_per_s=FEED_IMAGES / feed_s,
         device_busy_ms=busy_ms, idle_share=1 - busy_ms / (feed_s * 1e3),
         h2d=h2d)
    _say("image_feed_split", card=card, batch=FEED_BATCH,
         loader_batches=host_batches, loader_s=loader_s,
         loader_images_per_s=host_batches * FEED_BATCH / loader_s,
         pin_ms_per_batch=_pin_ms(host_batch),
         h2d_ms_per_batch=h2d["uint8_ms"],
         kernel_ms_per_batch=(sum(t for t, _ in kernel)
                              / max(1, sum(c for _, c in kernel)) / 1e3),
         kernel_launches_profiled=sum(c for _, c in kernel),
         feed_s=feed_s, feed_images_per_s=FEED_IMAGES / feed_s,
         feed_idle_share=1 - busy_ms / (feed_s * 1e3))
    return counts["fused_preprocess"], max(errors + [host_err])


# ----------------------------------------------------------------- phase 3
def serve(card: str, arch: str):
    """``Server.generate`` on full-width ``arch``: batch 4, 32 prompt + 32
    new tokens, greedy; the output is checked, a second server gives the
    same tokens, and the decode kernel is launched once per attention layer
    and token.  Then the family's comparison: for a model with attention,
    the served positions through the decode kernel and through plain
    attention (held in the served dtype for gemma-2b, in fp32 for zamba2);
    for mamba2, which decodes through no kernel, its decode logits against
    the train forward's through the ssd kernel."""
    job = ServeJob(arch=arch, smoke=False, batch=4, prompt_len=32,
                   max_new_tokens=32)
    torch.cuda.reset_peak_memory_stats()
    srv = Server(job)
    cfg = srv.cfg
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (job.batch, job.prompt_len)).astype(np.int32)
    total = job.prompt_len + job.max_new_tokens

    _reset_counts()
    out = srv.generate(prompts)
    counts = _counts()

    if out.shape != (job.batch, total):
        raise AssertionError(f"{arch}: output shape {out.shape}")
    if not (out[:, :job.prompt_len] == prompts).all():
        raise AssertionError(f"{arch}: prompt not preserved")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: token id out of vocab")
    _check_counts(counts, {"decode_attention": _attention_layers(cfg) * total},
                  arch)
    first = dict(srv.stats, tokens_per_s=srv.throughput())

    again = Server(job)
    if not np.array_equal(out, again.generate(prompts)):
        raise AssertionError(f"{arch}: a second Server gave other tokens")
    second = dict(again.stats, tokens_per_s=again.throughput())
    del again

    if cfg.family == "ssm":
        check = "decode vs the train forward through the ssd kernel"
        rel, steps = _decode_vs_forward(srv, 512), 512
    else:
        check = "decode kernel vs torch attention"
        held = cfg.dtype if cfg.family == "dense" else "float32"
        rel, steps = _decode_kernel_vs_torch(srv, out, held), total
    _say("serve", card=card, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, batch=job.batch, prompt_len=job.prompt_len,
         new_tokens=job.max_new_tokens, launches=counts,
         first_server=first, second_server=second, check=check,
         check_rel=rel, check_steps=steps,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         sample=out[0, job.prompt_len:job.prompt_len + 8].tolist())
    return srv, counts["decode_attention"]


def _decode_kernel_vs_torch(srv, out, held: str) -> dict:
    """The served tokens at the served positions, on a cache of the served
    length, through the decode kernel and through plain attention: the
    largest difference over the vocabulary's real slots relative to the
    largest logit, in the served dtype and in ``held`` (the served weights
    cast to fp32 for "float32").  Held at ``DECODE_RTOL`` in ``held`` only:
    zamba2's 54 mamba layers of random weights carry bf16's rounding of the
    attention output forward to several times that, where gemma-2b's 18
    dense layers do not, so zamba2 is held in fp32 and its bf16 reported."""
    cfg = srv.cfg
    rels = {}
    for dtype in dict.fromkeys((held, cfg.dtype)):
        params = (srv.params if dtype == cfg.dtype
                  else tree_map(lambda p: p.float(), srv.params))
        logits = {}
        with torch.inference_mode():
            for impl in ("torch", "kernel"):
                model = build_model(cfg.with_(dtype=dtype), attn_impl=impl)
                cache = model.init_cache(out.shape[0], out.shape[1],
                                         srv.device)
                per_step = []
                for t in range(out.shape[1]):
                    tok = torch.from_numpy(out[:, t]).to(srv.device,
                                                         torch.int64)
                    lg, cache = model.decode_step(params, cache, tok, t,
                                                  head=srv.head)
                    per_step.append(lg[:, :cfg.vocab_size].float())
                logits[impl] = torch.stack(per_step)
        if not torch.isfinite(logits["kernel"]).all():
            raise AssertionError("non-finite logits")
        rels[dtype] = max(((logits["kernel"][t] - logits["torch"][t])
                           .abs().max() / logits["torch"][t].abs().max()).item()
                          for t in range(out.shape[1]))
        del params, logits
    if not rels[held] < DECODE_RTOL:
        raise AssertionError(f"kernel vs torch attention: {rels}")
    return rels


def _decode_vs_forward(srv, steps: int) -> dict:
    """tests/test_models.py's rule at full width, batch 1: the decode logits
    of each of ``steps`` positions against the train forward's, whose scan
    runs through the ssd kernel, as the largest difference over the
    vocabulary's real slots relative to the largest logit (the pad slots
    are -1e30 in both).  Held at 2e-2 in fp32, the served weights cast up.
    In the served bf16 it is reported, not held: the two paths round at
    other places (the recurrence rounds dt, each state increment and the
    state to bf16 where the kernel sums in fp32), and 48 layers of random
    weights carry that forward.  Beside it, the same difference between the
    forward through the kernel and through plain ``ssd_chunked``."""
    cfg, V = srv.cfg, srv.cfg.vocab_size
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (1, steps))).to(srv.device)
    positions = torch.arange(steps, device=srv.device).expand(1, steps)
    out = {}
    for dtype in dict.fromkeys(("float32", cfg.dtype)):
        params = (srv.params if dtype == cfg.dtype
                  else tree_map(lambda p: p.float(), srv.params))
        dcfg = cfg.with_(dtype=dtype)
        fwd = {}
        with torch.inference_mode():
            for impl in ("kernel", "torch"):
                model = build_model(dcfg, attn_impl=impl)
                _reset_counts()
                h = model._embed_tokens(params, {"tokens": tokens})
                h = model.backbone(params, h, positions)
                fwd[impl] = model._logits(params, rmsnorm(
                    params["final_ln"], h, cfg.norm_eps), srv.head)[0, :, :V]
                _check_counts(_counts(), {"ssd_scan": cfg.num_layers}
                              if impl == "kernel" else {}, "mamba2 forward")
            model = build_model(dcfg)
            cache = model.init_cache(1, steps, srv.device)
            rel = []
            for t in range(steps):
                got, cache = model.decode_step(params, cache, tokens[:, t], t,
                                               head=srv.head)
                got = got[0, :V]
                if not torch.isfinite(got).all():
                    raise AssertionError(f"non-finite decode logits at {t}")
                want = fwd["kernel"][t]
                rel.append(((got - want).abs().max()
                            / want.abs().max()).item())
            fwd_rel = ((fwd["kernel"] - fwd["torch"]).abs().amax(-1)
                       / fwd["torch"].abs().amax(-1)).max().item()
        out[dtype] = {"max": max(rel), "argmax": int(np.argmax(rel)),
                      "at": {t: rel[t] for t in (0, 1, 255, 256, steps - 1)},
                      "forward_kernel_vs_torch": fwd_rel}
        del params, fwd
    if not out["float32"]["max"] < DECODE_RTOL:
        raise AssertionError(f"mamba2 decode vs forward: {out}")
    return out


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


def train_launches(cfg, steps: int) -> dict:
    """Each kernel's launches in ``steps`` forward and backward passes: twice
    per use with remat "full" (the forward, and again under remat in the
    backward)."""
    per = (2 if cfg.remat == "full" else 1) * steps
    ssd_layers = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": per * _attention_layers(cfg),
            "ssd_scan": per * ssd_layers}


def zipf_lake(job: TrainJob, vocab_size: int, a: float = 1.2) -> Dataset:
    """``build_token_dataset``'s lake (its tensors and their layout), with
    the tokens of each document drawn by Zipf's law, ids by rank.  Words in
    text follow it with an exponent near 1 (Zipf, 1949); numpy's sampler
    needs ``a`` > 1, and 1.2 is an arbitrary choice above that.  From
    uniform tokens there is nothing to learn but a flat output, and 8 steps
    at lr 3e-4 do not lower mamba2's loss beyond its noise, nor granite's
    (11.614 at step 1, 11.637 at step 8 on uniform tokens).  The step's time
    does not depend on the token values."""
    ds = build_token_dataset(Dataset(MemoryProvider()), num_docs=0,
                             commit=False)
    rng = np.random.default_rng(job.seed)
    for i in range(job.num_docs):
        n = int(job.seq_len * 4 * rng.uniform(0.75, 1.25))
        ranks = np.minimum(rng.zipf(a, n), vocab_size) - 1
        ds.append({"tokens": ranks.astype(np.int32), "doc_id": np.int64(i)})
    ds.commit(f"zipf tokens x{job.num_docs}")
    return ds


def train(card: str, job: TrainJob = TRAIN_JOB, tag: str = "train",
          data_ds=None):
    torch.cuda.reset_peak_memory_stats()
    ckpt = _TimedCheckpoints(MemoryProvider(), keep=job.keep_checkpoints)
    trainer = Trainer(job, ckpt=ckpt, data_ds=data_ds)
    cfg = trainer.cfg

    _reset_counts()
    out = trainer.run(restore=False)
    counts = _counts()

    losses = [h["loss"] for h in out["history"]]
    if len(losses) != job.steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    _check_counts(counts, train_launches(cfg, job.steps), tag)
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

    # one batch, the trained params: the kernels and the plain impls agree
    batch = next(trainer._batches())
    compare = {impl: loss_and_grad_norm(build_model(cfg, attn_impl=impl),
                                        state["params"], batch)
               for impl in ("kernel", "torch")}
    rel = {name: abs(compare["kernel"][i] - compare["torch"][i])
           / abs(compare["torch"][i]) for i, name in enumerate(("loss",
                                                                "grad_norm"))}
    if not max(rel.values()) < TRAIN_RTOL:
        raise AssertionError(f"kernel vs torch impls: {compare}")
    extra = {}
    if cfg.moe is not None:        # the load-balance loss of that batch
        with torch.no_grad():
            metrics = trainer.model.loss_fn(state["params"], batch)[1]
        extra = {"aux": metrics["aux"].item(), "ce": metrics["ce"].item()}

    step_s = statistics.median(h["sec"] for h in out["history"][1:])
    tokens = job.global_batch * job.seq_len
    _say(tag, card=card, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, remat=cfg.remat,
         batch=job.global_batch, seq_len=job.seq_len, steps=job.steps,
         warmup=job.warmup, lr=job.lr, launches=counts,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         step_s=[h["sec"] for h in out["history"]], median_step_s=step_s,
         tokens_per_s=tokens / step_s, peak_memory_gb=peak_gb,
         state_gb=state_gb, save_s=ckpt.copy_s + ckpt.write_s,
         save_copy_s=ckpt.copy_s, save_write_s=ckpt.write_s,
         restore_s=restore_s, host_peak_gb=host_peak_gb,
         kernel_vs_torch=compare, kernel_vs_torch_rel=rel, **extra)
    return trainer, state, batch, counts


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
            kernels[e.key] = {"ms_per_launch": per_launch,
                              "launches_per_call": per_call,
                              "ms_per_call": per_launch * per_call,
                              "irregular": e.count % calls != 0}
    busy = sum(k["ms_per_call"] for k in kernels.values())
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1]["ms_per_call"])
    # names cut to 100 characters for the line; a cut name met again keeps
    # its rank as a suffix, so that no kernel hides another
    shown = {}
    for rank, (name, k) in enumerate(by_time[:top]):
        shown[name[:100] if name[:100] not in shown
              else f"{name[:100]} #{rank}"] = k
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if kernels else None,
            "kernels_by_time": shown, "kernel_kinds": len(kernels)}


def trace_train(trainer, state, batch, card: str, tag: str = "trace_train",
                groups: bool = False):
    """Where one full-width train step spends its time (it trains on); with
    ``groups``, also its device ms by ``TRACE_GROUPS``."""
    step = kernel_times(lambda: trainer.step_fn(state, batch), calls=2, top=16)
    extra = {}
    if groups:
        extra["device_ms_by_group"] = device_ms_by_group(
            lambda: trainer.step_fn(state, batch), calls=2)
    _say(tag, card=card, arch=trainer.cfg.name,
         batch=list(batch["tokens"].shape), train_step=step, **extra)


# the groups of a step's device time, each kernel by the code that launched
# it (for a backward kernel, the forward op its autograd node came from):
# "dispatch" is the rest of ``moe_apply`` (router, top-k, sort, gathers,
# the buffer's scatter, SiLU-GLU, combine), "other" the rest of the model
# (norms, rope, residuals, embeddings, copies)
TRACE_GROUPS = ("flash", "attention backward (plain)", "expert GEMMs",
                "dispatch", "logits and loss", "optimizer", "other GEMMs",
                "other", "unattributed")
# the functions a grouped trace marks with a profiler range of their name
# (``scope:<name>``), for the time of the trace
TRACE_SCOPES = ((moe_lib, "moe_apply"), (model_lib.Model, "_dense_block"),
                (model_lib.Model, "_logits"),
                (model_lib, "softmax_cross_entropy"), (AdamW, "update"),
                (steps_lib, "apply_updates"))


@contextlib.contextmanager
def _scoped(targets=TRACE_SCOPES):
    """Each (owner, name) function of ``targets`` runs inside
    ``torch.profiler.record_function("scope:<name>")`` until the block
    ends: the ranges a grouped trace reads, made from outside the port (a
    profiler does not record Python frames on every version)."""
    from torch.profiler import record_function
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]
    for owner, name, fn in saved:
        def scoped(*args, _fn=fn, _scope=f"scope:{name}", **kw):
            with record_function(_scope):
                return _fn(*args, **kw)
        setattr(owner, name, scoped)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _enclosing(events) -> dict:
    """For each CPU event (by ``id``), the list of it and of the events that
    enclose it in time on its thread, innermost first: the ops and ranges
    it ran inside."""
    threads = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and not e.is_async:
            threads.setdefault(e.thread, []).append(e)
    out = {}
    for evs in threads.values():
        evs.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        stack = []
        for e in evs:
            while stack and stack[-1].time_range.end <= e.time_range.start:
                stack.pop()
            out[id(e)] = [e] + stack[::-1]
            stack.append(e)
    return out


def _trace_group(kernel: str, names: list) -> str:
    if "flash_fwd" in kernel:
        return "flash"
    if any("FlashAttentionBackward" in n for n in names):   # plain recompute
        return "attention backward (plain)"
    if "scope:update" in names or "scope:apply_updates" in names:
        return "optimizer"
    if "scope:moe_apply" in names:
        return "expert GEMMs" if "aten::bmm" in names else "dispatch"
    if "scope:_logits" in names or "scope:softmax_cross_entropy" in names:
        return "logits and loss"
    gemm = any(part in kernel.lower() for part in ("gemm", "nvjet", "xmma"))
    return "other GEMMs" if gemm else "other"


def device_ms_by_group(fn, calls: int) -> dict:
    """Device ms a call of ``fn`` by ``TRACE_GROUPS``, from a
    ``torch.profiler`` trace with ``TRACE_SCOPES`` marked: a kernel goes to
    the group of the ranges around the op that launched it.  An op the
    autograd engine runs for a node takes the ranges around the node's
    forward op (matched by thread and sequence number); code that runs
    inside a node in ranges of its own (a block's recompute under remat)
    keeps its own.  Kernels the profiler ties to no op are
    ``unattributed``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with _scoped(), profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    around = _enclosing(events)
    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and id(e) in around and \
                not e.name.startswith("autograd::engine"):
            forward.setdefault((e.thread, e.sequence_nr), e)
    ms = dict.fromkeys(TRACE_GROUPS, 0.0)
    busy = 0.0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.is_user_annotation:
            busy += e.self_device_time_total / 1e3
        if id(e) not in around or not e.kernels:
            continue
        chain = around[id(e)]
        at = next((i for i, n in enumerate(chain) if n.name.startswith(
            "autograd::engine::evaluate_function")), len(chain))
        names = [n.name for n in chain[:at]]
        if at < len(chain) and not any(n.startswith("scope:") for n in names):
            node = chain[at]
            names.append(node.name)
            key = (node.fwd_thread, node.sequence_nr)
            if key in forward:
                names += [n.name for n in around[id(forward[key])]]
        for k in e.kernels:
            ms[_trace_group(k.name, names)] += k.duration / 1e3
    ms["unattributed"] = busy - sum(ms.values())
    return {"calls": calls, "device_busy_ms": busy / calls,
            **{g: v / calls for g, v in ms.items()}}


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


# --------------------------------------------------------------- moe layer
def moe_layer(card: str):
    """One full-width granite MoE layer on the card at the train phase's 4 x
    1024 tokens, in bf16 and fp32, random weights and input from a seeded
    generator.  Its forward and backward run under
    ``torch.cuda.set_sync_debug_mode("error")``, so any op that waits on the
    device raises; two more calls on the same input give the same output bit
    for bit (the combine adds in a fixed order); in fp32 the output equals
    the same call on the CPU within ``MOE_RTOL`` of its largest magnitude,
    with the same expert ids but for near ties (``MOE_NEAR_TIE``).  Reports
    the share of assignments dropped at capacity, and in bf16 the ms of a
    forward, of a forward and backward, and of its three expert GEMMs."""
    base = get_arch(GRANITE)
    B, S = GRANITE_JOB.global_batch, GRANITE_JOB.seq_len
    T, d = B * S, base.d_model
    E, k = base.moe.num_experts, base.moe.top_k
    cap = moe_lib.capacity(T, base)
    report = {}
    for dtype in ("bfloat16", "float32"):
        cfg = base.with_(dtype=dtype)
        gen = torch.Generator("cuda").manual_seed(0)
        params = materialize(moe_lib.moe_specs(cfg), gen, "cuda")
        x = torch.randn((B, S, d), generator=gen, device="cuda").to(
            torch_dtype(dtype))
        g = torch.randn((B, S, d), generator=gen, device="cuda")
        paths, leaves = zip(*named_leaves(params))
        leaves = [p.detach().requires_grad_() for p in leaves]
        xg = x.detach().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_lib.moe_apply(unflatten(zip(paths, leaves)), xg, cfg)
            grads = torch.autograd.grad((y.float() * g).sum() + aux,
                                        leaves + [xg])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        with torch.no_grad():
            again = [moe_lib.moe_apply(params, x, cfg)[0] for _ in range(2)]
            idx, _, _ = moe_lib._route(params, x.reshape(T, d), cfg)
            keep = moe_lib.dispatch(idx, cap, E)[3]
        if not (torch.equal(again[0], again[1]) and torch.equal(again[0], y)):
            raise AssertionError(f"moe {dtype}: two calls differ")
        if not (torch.isfinite(y).all() and all(torch.isfinite(t).all()
                                                 for t in grads)):
            raise AssertionError(f"moe {dtype}: non-finite output or grads")
        row = {"aux": aux.item(), "dropped_share": 1 - keep.float().mean().item(),
               "grad_norm": torch.sqrt(sum(t.float().square().sum()
                                           for t in grads)).item(),
               "max_abs_out": y.abs().max().item(), "sync_free": True,
               "bit_equal": True}
        # the same call on the CPU: expert ids, and in fp32 the output
        cpu_params = tree_map(lambda t: t.cpu(), params)
        xc = x.cpu()
        with torch.no_grad():
            idx_c = moe_lib._route(cpu_params, xc.reshape(T, d), cfg)[0]
            probs = torch.sort(torch.softmax(xc.reshape(T, d).float()
                                             @ cpu_params["router"], -1),
                               -1, descending=True).values
        near = (probs[:, k - 1] - probs[:, k]) < MOE_NEAR_TIE * probs[:, k - 1]
        same = (idx.cpu().sort(-1).values == idx_c.sort(-1).values).all(-1)
        row.update(near_ties=int(near.sum()), ids_differ=int((~same).sum()))
        if not bool((same | near).all()):
            raise AssertionError(f"moe {dtype}: expert ids differ from the "
                                 f"CPU's on {int((~same & ~near).sum())} tokens")
        if dtype == "float32":
            with torch.no_grad():
                want = moe_lib.moe_apply(cpu_params, xc, cfg)[0].reshape(T, d)
            got = y.detach().cpu().reshape(T, d)
            rel = ((got - want)[same].abs().max() / want.abs().max()).item()
            row["card_vs_cpu_rel"] = rel
            if not rel <= MOE_RTOL:
                raise AssertionError(f"moe fp32 card vs CPU: {rel}")
        else:
            with torch.no_grad():
                row["fwd_ms"] = call_ms(lambda: moe_lib.moe_apply(
                    params, x, cfg), calls=5)
                buf = torch.randn((E, cap, d), generator=gen, device="cuda"
                                  ).to(x.dtype)
                hid = torch.randn((E, cap, base.moe.d_expert), generator=gen,
                                  device="cuda").to(x.dtype)
                row["expert_gemms_ms"] = device_ms(lambda: (
                    torch.bmm(buf, params["wi"]), torch.bmm(buf, params["wg"]),
                    torch.bmm(hid, params["wo"])), calls=5, replays=4)
            row["fwd_bwd_ms"] = call_ms(lambda: torch.autograd.grad(
                (moe_lib.moe_apply(unflatten(zip(paths, leaves)), xg,
                                   cfg)[0].float() * g).sum(), leaves + [xg]),
                calls=5)
        report[dtype] = row
        del params, x, g, leaves, xg, y, grads, again, cpu_params, xc
        torch.cuda.empty_cache()
    _say("moe", card=card, arch=GRANITE, tokens=T, d_model=d, experts=E,
         top_k=k, d_expert=base.moe.d_expert, capacity=cap,
         near_tie=MOE_NEAR_TIE, rtol=MOE_RTOL, **report)
    return report


def granite(card: str):
    """Phases 9 and 10: one granite MoE layer; granite's training from a
    lake of Zipf tokens, then the trace of one of its steps by group."""
    moe_layer(card)
    lake = zipf_lake(GRANITE_JOB, get_arch(GRANITE).vocab_size)
    trainer, state, batch, _ = train(card, GRANITE_JOB, "train_granite", lake)
    trace_train(trainer, state, batch, card, "trace_train_granite",
                groups=True)


# ----------------------------------------------------------------- phase 8
def zamba2(card: str, ssd_here: dict):
    """Loss and gradients of one batch on full-width zamba2-2.7b through the
    kernels and through the plain impls; no optimizer (its state would be a
    27 GB checkpoint).  Each route is timed in every round of
    ``ZAMBA2_ORDER``, the first route alternating, and reported as its
    readings, their median and spread, beside the ssd and flash kernels'
    device ms and their plain versions' at the shapes this pass gives them
    (``ssd_here``: ``ssd_timings`` at ``SSD_ZAMBA2``)."""
    cfg = get_arch("zamba2-2.7b")
    B, S = 2, 1024
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg).init(torch.Generator("cuda").manual_seed(0),
                                   "cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to("cuda")
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    out, secs, counts = {}, {"kernel": [], "torch": []}, {}
    for order in ZAMBA2_ORDER:
        for impl in order:
            _reset_counts()
            t0 = time.perf_counter()
            got = loss_and_grad_norm(build_model(cfg, attn_impl=impl),
                                     params, batch)
            torch.cuda.synchronize()
            secs[impl].append(time.perf_counter() - t0)
            out.setdefault(impl, got)
            counts.setdefault(impl, _counts())
    _check_counts(counts["kernel"], train_launches(cfg, 1), "zamba2")
    _check_counts(counts["torch"], {}, "zamba2 plain")
    rel = {name: abs(out["kernel"][i] - out["torch"][i]) / abs(out["torch"][i])
           for i, name in enumerate(("loss", "grad_norm"))}
    if not (max(rel.values()) < TRAIN_RTOL
            and all(math.isfinite(v) for v in out["kernel"])):
        raise AssertionError(f"zamba2 kernel vs torch impls: {out}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, batch
    flash = flash_timings(**FLASH_ZAMBA2, card=card)
    _say("zamba2", card=card, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, remat=cfg.remat, batch=B,
         seq_len=S, launches=counts["kernel"], loss_and_grad_norm=out,
         kernel_vs_torch_rel=rel, seconds=secs,
         median_s={k: statistics.median(v) for k, v in secs.items()},
         spread_s={k: max(v) - min(v) for k, v in secs.items()},
         ssd_at_its_shape=ssd_here,
         flash_at_its_shape=flash, peak_memory_gb=peak_gb)
    return flash


# ---------------------------------------------------------------- phase 10
def library_call(q, k, v, pos):
    """``scaled_dot_product_attention`` over the cache with a validity mask:
    the yardstick, never called by the port."""
    T = k.shape[1]
    q4 = q[:, :, None]                        # (B,H,1,D)
    k4, v4 = k.transpose(1, 2), v.transpose(1, 2)   # (B,Hkv,T,D)
    mask = (torch.arange(T, device=q.device) < min(pos + 1, T))[None, None, None]
    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                          enable_gqa=True)


def _bound(kernel: str, shape: str, nbytes: int, ops: int,
           ops_per_s: float, card: str) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over the
    memory rate and ``ops`` over ``ops_per_s``.  The counts it comes from go
    on a ``[bound]`` line of their own."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    _say("bound", kernel=kernel, shape=shape, bytes=nbytes, ops=ops,
         bytes_ms=t_bytes, ops_ms=t_ops, ops_per_s=ops_per_s,
         fp32_cores_ms=ops / FP32_OPS_PER_S * 1e3, card=card)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timings(B: int, H: int, Hkv: int, D: int, T: int, pos: int, card: str):
    """The decode kernel in bf16: device ms, the ms of a call issued from
    Python, the plain version's and SDPA's device ms, and the byte bound
    (the valid K/V entries, q and the output, each moved once)."""
    q, k, v = _inputs(B, H, Hkv, D, T, torch.bfloat16, seed=5)
    limit = min(pos + 1, T)
    nbytes = (2 * B * limit * Hkv * D + 2 * B * H * D) * 2
    ops = 4 * B * H * limit * D
    shape = f"B={B} H={H} Hkv={Hkv} D={D} T={T} pos={pos} bf16"
    lib = library_call(q, k, v, pos)
    ref = decode_attention_ref(q, k, v, pos=pos)
    lib_err = (lib[:, :, 0].float() - ref.float()).abs().max().item()
    cut = da_ops.plan(B, H, Hkv, D, limit,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    return {
        "shape": shape,
        "plan": cut._asdict(),
        "ms": device_ms(lambda: decode_attention(q, k, v, pos=pos)),
        "call_ms": call_ms(lambda: decode_attention(q, k, v, pos=pos)),
        "plain_ms": device_ms(lambda: decode_attention_ref(q, k, v, pos=pos)),
        "library_ms": device_ms(lambda: library_call(q, k, v, pos)),
        "library_max_abs_err": lib_err,
        **_bound("decode_attention", shape, nbytes, ops, FP32_OPS_PER_S, card),
        "card": card,
    }


def flash_timings(B: int, S: int, card: str, H: int = GEMMA["H"],
                  Hkv: int = GEMMA["Hkv"], D: int = GEMMA["D"]):
    """The flash kernel, causal, bf16; at gemma-2b's widths by default."""
    q, k, v = _flash_inputs(B, S, H, Hkv, D, torch.bfloat16, seed=5)
    pairs = S * (S + 1) // 2                    # causal (query, key) pairs
    ops = 4 * B * H * D * pairs                 # QK^T and PV, 2 each a pair
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * 2
    shape = f"B={B} S={S} H={H} Hkv={Hkv} D={D} causal bf16"
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))   # (B, heads, S, D)

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)
    lib_err = (library().transpose(1, 2).float()
               - ref_attention(q, k, v).float()).abs().max().item()
    return {
        "shape": shape,
        "ms": device_ms(lambda: flash_attention(q, k, v)),
        "call_ms": call_ms(lambda: flash_attention(q, k, v), calls=20),
        "plain_ms": device_ms(lambda: ref_attention(q, k, v), calls=5,
                              replays=4),
        "library_ms": device_ms(library),
        "library_max_abs_err": lib_err,
        **_bound("flash_attention", shape, nbytes, ops, BF16_OPS_PER_S, card),
        "card": card,
    }


def ssd_timings(shape, card: str):
    """The ssd kernel in bf16: its bound is the larger of the bytes (x, dt,
    A, B and C read once, y and the state written once) over the memory rate
    and the operations, Q(Q+1)(N+P) + 4QNP for each (b, h, chunk), at the
    bf16 tensor-core peak.  Beside it, the bf16 route's own byte floor (x
    read twice, y written once, the chunk states (B, S/Q, nh, N, P) fp32
    written, read, written and read, B, C, dt read once, the state written
    once) over the memory rate; the ms of a call issued from Python; and
    each pass's device ms from the profiler."""
    B, S, nh, P, G, N, Q = shape
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, nh, P, G, N, torch.bfloat16, seed=5)
    x_bytes, states_bytes = B * S * nh * P * 2, B * S // Q * nh * N * P * 4
    rest = B * S * nh * 4 + 2 * B * S * G * N * 2 + B * nh * N * P * 4
    nbytes = 2 * x_bytes + rest + nh * 4
    floor_bytes = 3 * x_bytes + 4 * states_bytes + rest
    ops = B * nh * (S // Q) * (Q * (Q + 1) * (N + P) + 4 * Q * N * P)
    shape = f"B={B} S={S} nh={nh} P={P} G={G} N={N} Q={Q} bf16"

    def call():
        return ssd(x, dt, A, Bm, Cm, chunk=Q)
    with torch.no_grad():
        for _ in range(3):   # a profiler session may keep no record
            passes = {re.search(r"ssd_\w+(<[\w, ]+>)?", k).group(0):
                      v["ms_per_launch"] for k, v in
                      kernel_times(call, calls=5)["kernels_by_time"].items()
                      if "ssd_" in k}
            if len(passes) == len(SSD_ROUTES[torch.bfloat16]):
                break
        out = {
            "shape": shape,
            "ms": device_ms(call),
            "call_ms": call_ms(call, calls=20),
            "plain_ms": device_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm,
                                                      chunk=Q),
                                  calls=3, replays=3),
            **_bound("ssd_scan", shape, nbytes, ops, BF16_OPS_PER_S, card),
            "design_floor_bytes": floor_bytes,
            "design_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3,
            "passes_ms": passes,
            "library_ms": None,
            "card": card,
        }
    return out


def preprocess_timings(card: str, rotation: int = 5):
    """The crop-normalize kernel at the image feed's batch: its bound is the
    window's bytes read once and the fp32 output written once, over the
    memory rate, against three fp32 operations an element.  ``ms`` is one
    batch (48 MB) called again and again, which may stay in the 50 MB L2
    cache; ``rotation_ms`` turns through ``rotation`` distinct batches (240
    MB), so each call reads its batch from device memory; ``call_ms`` is a
    call issued from Python."""
    batches = [_images((FEED_BATCH, 250, 250, 3), seed=5 + i)
               for i in range(rotation)]
    x = batches[0]
    turn = itertools.cycle(batches)
    _, _, h, w = FEED_CROP
    n = FEED_BATCH * h * w * 3
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")   # made outside the
    std = torch.tensor(IMAGENET_STD, device="cuda")     # graph's capture
    shape = f"B={FEED_BATCH} 250x250x3 uint8 crop={FEED_CROP} -> fp32"
    out = {
        "shape": shape,
        "ms": device_ms(lambda: fused_preprocess(x, FEED_CROP, IMAGENET_MEAN,
                                                 IMAGENET_STD)),
        "rotation_ms": device_ms(
            lambda: fused_preprocess(next(turn), FEED_CROP, IMAGENET_MEAN,
                                     IMAGENET_STD), calls=4 * rotation),
        "rotation_input_mb": rotation * x.numel() / 1e6,
        "call_ms": call_ms(lambda: fused_preprocess(x, FEED_CROP,
                                                    IMAGENET_MEAN,
                                                    IMAGENET_STD)),
        "plain_ms": device_ms(lambda: ref_preprocess(x, FEED_CROP, mean, std)),
        **_bound("fused_preprocess", shape, n * (1 + 4), 3 * n,
                 FP32_OPS_PER_S, card),
        "library_ms": None,
        "card": card,
    }
    del batches, turn
    # PRE_CASES' 3.1 GB batch, whose byte index passes 2**31
    big, crop = _images((16384, 250, 250, 3)), (200, 200, 50, 50)
    big_n = 16384 * 50 * 50 * 3
    big_shape = f"B=16384 250x250x3 uint8 crop={crop} -> fp32"
    out["large"] = {
        "shape": big_shape,
        "ms": device_ms(lambda: fused_preprocess(big, crop, IMAGENET_MEAN,
                                                 IMAGENET_STD), calls=5),
        **_bound("fused_preprocess", big_shape, big_n * (1 + 4), 3 * big_n,
                 FP32_OPS_PER_S, card)}
    del big
    torch.cuda.empty_cache()
    _say("preprocess_timings", **out)
    return out


def main() -> None:
    t_start = time.perf_counter()
    card = environment()
    errors = kernel_vs_plain()
    flash_errors = flash_vs_plain()
    ssd_errors = ssd_vs_plain()
    # timed here, where the profiler's per-pass records are kept
    ssd_train, ssd_zamba2, ssd_long = (ssd_timings(shape, card) for shape in
                                       (SSD_MAMBA2, SSD_ZAMBA2, SSD_LONG))
    pre_errors = preprocess_vs_plain()
    feed_launches, feed_err = image_feed(card)
    torch.cuda.empty_cache()
    srv, launches = serve(card, "gemma-2b")
    trace(srv, card)
    del srv
    torch.cuda.empty_cache()
    trainer, state, batch, counts = train(card)
    flash_launches = counts["flash_attention"]
    resume(card)
    trace_train(trainer, state, batch, card)
    del trainer, state, batch
    torch.cuda.empty_cache()
    lake = zipf_lake(MAMBA2_JOB, get_arch(MAMBA2_JOB.arch).vocab_size)
    trainer, state, batch, counts = train(card, MAMBA2_JOB, "train_mamba2",
                                          lake)
    ssd_launches = counts["ssd_scan"]
    trace_train(trainer, state, batch, card, "trace_train_mamba2")
    del trainer, state, batch, lake
    torch.cuda.empty_cache()
    zamba2_train = zamba2(card, ssd_zamba2)
    torch.cuda.empty_cache()
    granite(card)
    torch.cuda.empty_cache()
    for arch in ("mamba2-1.3b", "zamba2-2.7b", GRANITE):
        serve(card, arch)
        torch.cuda.empty_cache()
    decode_rows = [timings(*shape, card=card) for shape in DECODE_TIMED]
    serving = decode_rows[0]          # the served cache, T=64
    training = flash_timings(4, 1024, card)
    long_train = flash_timings(4, 4096, card)
    granite_train = flash_timings(**FLASH_GRANITE, card=card)
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
        "zamba2_shape": zamba2_train,
        "granite_shape": granite_train,
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
        "shapes": decode_rows,
    }
    ssd_entry = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:77",
        "launches": ssd_launches,
        "max_abs_err": max(ssd_errors.values()),
        **{k: ssd_train[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "library_note": "no single PyTorch call computes SSD",
        "training_shape": ssd_train,
        "long_shape": ssd_long,
        "zamba2_shape": ssd_zamba2,
    }
    pre = preprocess_timings(card)
    pre_entry = {
        "name": "fused_preprocess",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_preprocess/csrc/fused_preprocess.cu",
        "replaces": "src/repro/kernels/fused_preprocess/fused_preprocess.py:31",
        "launches": feed_launches,
        "max_abs_err": max(max(pre_errors.values()), feed_err),
        **{k: pre[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
        "library_note": "no single PyTorch call crops, casts and normalizes",
        "feed_shape": pre,
    }
    _say("done", script_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [entry, flash_entry, ssd_entry, pre_entry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
