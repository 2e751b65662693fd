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
   other configs' widths (granite's, phi-3-vision's, musicgen's and
   starcoder2's served caches among them, and starcoder2's 4096-slot ring
   wrapped past 8192) and edge cases of head grouping and D; the
   profiler's kernel names show each bf16 case on the tensor-core kernel,
   each fp32 case on the CUDA-core one, and a one-split case in one launch.
   Flash attention: the JAX flash sweep's shapes,
   gemma-2b's training shape (B=4, S=1024, H=8, Hkv=1, D=256), ragged S,
   starcoder2's and gemma3's sliding windows, D of 32, 40, 96 and 128, G of
   1, 2 and 8, zamba2's shared block (D=80), granite-moe-1b-a400m's training
   shape (B=4, S=1024, H=16, Hkv=8, D=64), MLA's training shape at full
   deepseek-v3 width (B=4, S=1024, H=Hkv=128, D=192: V padded to the QK
   dim), the training shapes of phase 12's three models and starcoder2's
   prefill at twice its window (B=1, S=8192); the profiler's kernel names show
   each bf16 case on the tensor-core kernel and each fp32 case on the
   CUDA-core one; the [prefill] phase's shape (B=4, S=32768, gemma-2b's
   widths) on three blocks of query rows against the plain
   ``blockwise_attention`` with their offset (``ref_attention`` would
   materialize 137 GB); and one gradient through its autograd function against plain
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
   must refuse.  ``[decode_seq_split]``: decode on a cache split over its
   keys, as the ranks of a ``--seq-shard`` mesh hold it, in one process:
   the cache cut into 4 and into 16 slices, the partial entry
   (``decode_attention_partial``: out and log-sum-exp) on each, the slices
   merged by the mesh path's ``merge_partials``, in fp32 and bf16, with
   pos at the end and in the middle (empty slices, one partly valid with
   several splits, or with so few keys that one split writes its lse), at
   gemma-2b's widths (T=32768) and at one (16, 16) rank's share of
   qwen2-72b decode_32k (B=8, H=64, Hkv=8, D=128, slices of 2048 keys);
   each slice's out and lse against the plain partial's, the merged result
   against the whole-cache kernel and the plain version, outputs at ``TOL``
   of the reference's largest magnitude plus ``TOL`` relative (the gate
   shown to refuse every slice's P.V off by 30%); one full slice timed
   against its byte bound.  ``kernel_vs_plain`` also holds the partial
   entry over the whole cache bit for bit against the launch without lse;
2a. deepseek: full-width deepseek-v3-671b (d 7168, 128 heads of MLA, 256
   routed experts and one shared, MTP depth 1), its depth cut inside the
   script after each entry point is built (the full 61 layers fit no card),
   run before the phases that grow the host's memory, with the process's
   resident memory printed around it.  ``[serve_deepseek]``: phase 3's
   ``serve`` at depth 4 (the 3 leading dense layers and 1 MoE layer), with
   no decode-kernel launch (MLA decodes in plain ops over its latent cache,
   as in JAX); ``[mla_decode_vs_forward]``: at depth 3 (no MoE layer), the
   absorbed decode logits at 64 positions against the train forward's
   through ``mla_train``, and the first 32 tokens prefilled (no kernel) and
   the rest decoded from the padded cache against that decode, within 2e-2
   in fp32 (bf16 reported);
   ``[grad_deepseek]``: one loss and gradient of the depth-4 model with MTP
   on 1 x 1024 tokens, finite, with ce, aux and mtp; ``[train_deepseek]``:
   phase 4's gates at depth 1 plus MTP (8 steps of 4 x 1024 Zipf tokens,
   bf16 AdamW moments, a checkpoint of its whole state restored bit for
   bit; ``TRAIN_CUT``) and ``mtp`` at each step, then the trace of one step
   by group;
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
   kernel and through the plain ``torch`` attention agree; and the prompt
   through ``make_prefill_step`` (the flash kernel once per layer), its
   cache padded and the new tokens decoded from it, agree with that decode;
3a. prefill: ``make_prefill_step`` on the served gemma-2b at B=4, S=32768
   (prefill_32k's length, its batch of 32 cut to 4): three prefills timed,
   18 flash launches each and no other kernel, finite logits, tokens/s,
   peak memory, the cache's 2.4 GB, the device ms by group; 8 decode steps
   from the padded cache through the decode kernel against the forward over
   S + 8 tokens (its last positions' logits only), within 2e-2 in fp32 at
   B=1 (bf16 at B=4 reported); and at S=4096 the logits and caches through
   the kernel against the plain ``torch`` and ``torch_pairs`` impls;
4. train: ``Trainer.run`` on full-width gemma-2b (bf16, remat "full"): 8
   steps of batch 4 x 1024 tokens streamed from a lake of synthetic
   documents through ``DeviceFeeder``, through the flash kernel twice per
   layer and step (forward, and again under remat in the backward); finite
   and falling loss; one checkpoint committed into the lake, which restores
   into an equal state; the loss and gradient norm of one batch through the
   kernel and through the plain ``torch`` attention agree;
5. resume: an injected ``HostFailure`` at step 5 of a smoke-config run on the
   card, and its resumption from the lake's checkpoint;
5a. dist: the distributed path in an NCCL world of one (``dist``): phase
   4's checkpoint restored bit for bit onto a (1, 1) ``DeviceMesh``
   (``dist_restore``, right after phase 4, before its state trains on);
   the train phase's job through ``Trainer`` on the mesh, the state as
   DTensors, its losses held against phase 4's, 2 x 18 flash launches a
   step; the int8 all-reduce on one step's gradients against numpy; the
   served gemma-2b on the mesh giving phase 3's greedy tokens through the
   decode kernel; ``gqa_decode`` at gemma-2b's widths on a cache placed as
   ``--seq-shard``'s rules place it (``key_split_decode``: the key split
   kept on the size-1 "model" dim), through ``split_call``, the partial
   entry on ``local_call``'s shards and the merge's NCCL all-reduces,
   against the meshless ``gqa_decode``.  Each group is destroyed after its
   part;
6. trace: where one full-width decode step and one full-width train step
   spend their time on the device (``torch.profiler``);
7. train mamba2: ``Trainer.run`` on full-width mamba2-1.3b (cut to 16 of its
   48 layers, ``TRAIN_CUT``; bf16, remat "full"): 8 steps of batch 4 x 2048 streamed from a lake of
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
10. train granite: ``Trainer.run`` on full-width granite-moe-1b-a400m (cut
   to 8 of its 24 layers, ``TRAIN_CUT``; bf16, remat "full"): phase 4's
   gates (8 steps of 4 x 1024 from phase 7's lake of Zipf tokens, the flash
   kernel 2 x 8 times a step, a checkpoint restored bit for bit, kernel vs
   plain attention within 2e-2) and the batch's aux loss;
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
   and each model's prefill and its continuation against its decode, as
   in phase 3, in fp32 (granite at its dropless capacity factor 16; the
   mamba layers scan through the plain ``ssd_chunked``, as in JAX);
12. families: full-width starcoder2-3b (30 layers, GQA with G=12, a
   4096-token window, qkv bias), phi-3-vision-4.2b (32 layers, D=96, 256
   image positions spliced in) and musicgen-medium (48 layers, 4 codebooks
   of 2048, D=64), each at full depth (``family``): ``[train_*]``, phase
   4's gates with no checkpoint (8 steps of 4 x 1024 Zipf tokens, musicgen's
   as (B, 4, S) grids from ``TokenBatcher``, phi-3-vision's with the
   Trainer's (4, 256, 1024) image embeddings; the flash kernel 2 x L times a
   step), and its ``[dryrun]`` step; ``[serve_*]``, phase 3's ``serve``
   (starcoder2 held in bf16, phi-3-vision text only and held in fp32) with
   one Server, and for musicgen, which ``Server.generate`` does not take,
   (4, 4, 32) prompts through ``make_prefill_step`` and 32 greedy steps of
   ``make_decode_step`` (``_codebook_generate``), held in fp32 on its
   (B, 4, V) logits; ``[past_window_*]``: a prompt prefilled, then 16
   decode steps, against the forward over the whole, within 2e-2 in fp32 at
   batch 1 (bf16 at batch 4 reported): starcoder2 at 8192 positions, twice
   its window, so that decode writes ring slots 0-15 of a wrapped 4096-slot
   cache; phi-3-vision 256 image and 768 text positions; musicgen 1024;
13. numbers: ``{"kernels": [...]}`` with each kernel's launches on its main
   path, its largest error, and its time beside its bound, the plain
   version's and one PyTorch call's (none computes SSD, none crops and
   normalizes), at the main path's shapes (decode at gemma-2b's widths with
   T of 64, 1024, 4096 and 32768 and at zamba2's served shape, each also as
   the ms of one call issued from Python; flash also at zamba2's shared
   block, B=2 S=1024 H=Hkv=32 D=80, from phase 8, and at the [prefill]
   phase's B=4 S=32768, whose plain version is ``blockwise_attention``;
   each entry's launches count phase 3a's too; ssd at mamba2's, the long
   and zamba2's shapes, with the ms of a call, each pass's ms and the bf16
   route's own byte floor; preprocess at the feed's batch with it in L2 and
   over a rotation of 5 batches, the ms of a call, and the 3.1 GB case); a
   ``[bound]`` line for each timed shape with the bytes and operations its
   bound comes from; decode and flash also at granite's served and
   training shapes (H=16, Hkv=8, D=64); decode at starcoder2's wrapped ring
   (T=4096) and phi-3-vision's and musicgen's served caches, flash at the
   three families' training shapes and starcoder2's windowed prefill (B=4,
   S=8192, window 4096), each entry's launches counting phase 12's;
   yardsticks for MLA, which runs no
   kernel: flash at MLA's training shape beside SDPA and the port's plain
   ``blockwise_attention``, and one absorbed ``mla_decode`` layer at B=4,
   T=32768 beside its byte bound; and the script's total time.

``[dryrun]`` lines, one for each step it predicts: the dry run
(``launch/steps.py::trace_cell``: the step run once on fake tensors, with
no mesh, each kernel call reported in place of a launch) against one real
step of the same shape, dtype and remat on the card, right after the phase
that runs it: gemma-2b training (phase 4), its prefill (phase 3a) and a
decode step at the served cache (phase 3), mamba2-1.3b training (phase 7),
granite-moe-1b-a400m training (phase 10) and the three families' training
(phase 12).  Gates: the predicted state
bytes equal the real state's exactly; the predicted kernel calls equal the
launch counters' delta; and, for gemma-2b's training and prefill, the
predicted peak is within ``PEAK_RTOL`` of the card's (the card's
``max_memory_allocated`` over the step, less what it held beside the
step's arguments before the step).  Each line also gives the roofline's
bound on H100 figures, its dominant term, ``mfu`` (``model_flops`` over
the phase's median step s times 989e12) and the bound's share of the step.
The real steps' launches are added to the ``{"kernels"}`` counts.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import itertools
import json
import math
import multiprocessing
import os
import re
import resource
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

T_START = time.perf_counter()
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
from repro_torch.distributed.sharding import (  # noqa: E402
    _local_range, merge_partials, slice_limit)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_partial, decode_attention_partial_ref,
    decode_attention_ref, ops as da_ops)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, ops as fa_ops, ref_attention)
from repro_torch.kernels.fused_preprocess import (  # noqa: E402
    fused_preprocess, ops as fp_ops, ref_preprocess)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ops as ssd_ops, ref_ssd, ssd)
import repro_torch.launch.steps as steps_lib  # noqa: E402
import repro_torch.models.attention as attn_lib  # noqa: E402
import repro_torch.models.model as model_lib  # noqa: E402
from repro_torch.launch.serve import Server, ServeJob  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    Roofline, active_param_count, model_flops)
from repro_torch.launch.steps import train_state_specs  # noqa: E402
from repro_torch.launch.train import Trainer, TrainJob  # noqa: E402
from repro_torch.models import abstract, build_model, named_leaves  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    count_params, materialize, torch_dtype, tree_map, unflatten)
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
DECODE_RTOL = 2e-2                                  # tests/test_models.py:83
TRAIN_RTOL = 2e-2                                   # tests/test_models.py:83
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_RTOL = 0.2      # [dryrun]: the predicted peak against the card's
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
# the deepseek phases: full-width deepseek-v3-671b, its depth cut in the
# script (the 671B tree fits no card): serving and one gradient at depth 4,
# the 3 leading dense layers and 1 MoE layer (31.6 GB of bf16 params); the
# decode check at depth 3 (scripts/mesh_smoke.py also trains there), no MoE
# layer (AdamW's state of one MoE layer alone is ~92 GB); training at
# ``TRAIN_CUT``'s depth: 8 steps of 4 x 1024 Zipf tokens.  AdamW moves
# each weight by about lr a step, so a d-wide product's output by about
# lr * d of its scale: the other phases' 3e-4 is 0.31 of it at granite's
# d of 1024, 2.2 at deepseek's 7168, where the loss went 15.8 -> 37.9 ->
# 15.7 in 8 steps; so lr is scaled by 1024 / 7168 to granite's 0.31
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_SERVE_LAYERS = 4
DEEPSEEK_TRAIN_LAYERS = 3
DEEPSEEK_JOB = TrainJob(arch=DEEPSEEK, smoke=False, steps=8, global_batch=4,
                        seq_len=1024, lr=3e-4 * 1024 / 7168, warmup=2,
                        num_docs=16, checkpoint_every=8, log_every=1)
DEEPSEEK_GRAD_TOKENS = (1, 1024)   # the [grad_deepseek] batch
MOE_RTOL = 1e-4           # the [moe] phase: fp32 card against the CPU
# a token whose k-th and (k+1)-th router probabilities lie closer than this
# share of the k-th may choose another expert on another device: fp32
# rounding, not a fault; such tokens are counted and left out of the gate
MOE_NEAR_TIE = 1e-5
# the depth the training phases of deepseek-v3, mamba2 and granite run at
# here: each checkpoints its whole state into the lake and restores it, at
# ~0.4 GB/s, which at the depths above took most of the script's time
# (scripts/mesh_smoke.py trains them at those depths); gemma-2b's training,
# the main path, keeps its 18 layers
TRAIN_CUT = {DEEPSEEK: 1, "mamba2-1.3b": 16, GRANITE: 8}
# the [family_*] phases: full-width starcoder2-3b (dense GQA, G=12, a
# 4096-token window, qkv bias), phi-3-vision-4.2b (vlm: 256 spliced image
# positions, D=96) and musicgen-medium (audio: 4 codebooks of 2048, D=64),
# each at full depth: 8 steps of 4 x 1024 Zipf tokens, with no checkpoint
# ([train]'s gemma-2b holds that path, at ~0.4 GB/s); trained at 1024, short
# of starcoder2's window, since the flash backward's plain recompute builds
# B*H*S*T fp32 scores.  One loader worker, so that the batches come in the
# seeded order.  The lr (scripts/lr_probe.py): at 3e-4 and 1e-4
# starcoder2's and phi-3-vision's losses (d 3072, 30 and 32 layers) rose by
# up to 9 nats and were no lower after 8 steps; at 1e-4 with a warmup of 8
# and at 3e-5 they fell with rises of up to 4.5 nats between; at 1e-5 they
# fell at nearly every step (10.94 -> 7.69, 10.82 -> 10.15).  musicgen
# (d 1536) fell at each of 3e-4 to 1e-5, steadily from 3e-5 down
STARCODER2, PHI3V, MUSICGEN = ("starcoder2-3b", "phi-3-vision-4.2b",
                               "musicgen-medium")
FAMILIES = (STARCODER2, PHI3V, MUSICGEN)
FAMILY_LR = {STARCODER2: 1e-5, PHI3V: 1e-5, MUSICGEN: 3e-5}
FAMILY_JOBS = {arch: TrainJob(arch=arch, smoke=False, steps=8, global_batch=4,
                              seq_len=1024, lr=FAMILY_LR[arch], warmup=2,
                              num_docs=16, checkpoint_every=8, log_every=1,
                              loader_workers=1)
               for arch in FAMILIES}
# [past_window]: each family's prompt prefilled, then PAST_STEPS decode steps
# against the train forward over the whole: starcoder2 at twice its window
# (its prefill cache then in ring order, the decode written into ring slots
# 0..15 over the oldest keys), phi-3-vision 256 image and 768 text positions,
# musicgen 1024 positions of 4 codebooks
PAST_PROMPT = {STARCODER2: 8192, PHI3V: 1024, MUSICGEN: 1024}
PAST_STEPS = 16
# each kernel's wrapper and its launch counter
COUNTED = {"decode_attention": decode_attention,
           "flash_attention": flash_attention, "ssd_scan": ssd,
           "fused_preprocess": fused_preprocess}

# [decode_seq_split]: the cache cut into these many key slices, at
# gemma-2b's widths and at one (16, 16) rank's share of qwen2-72b
# decode_32k (its batch of 128 over "data", T over "model": 2048 keys a
# slice when cut 16 ways); pos at the end, and in the middle, SEQ_MID
# keys into a slice (a plan of several splits) or SEQ_ONE (fewer than
# ops.MIN_SPLIT_LEN: one split, which writes its lse itself), the later
# slices empty
SEQ_SPLITS = (4, 16)
SEQ_WIDTHS = {"gemma-2b": dict(B=4, H=8, Hkv=1, D=256, T=32768),
              "qwen2-72b share": dict(B=8, H=64, Hkv=8, D=128, T=16 * 2048)}
SEQ_MID = 1000
SEQ_ONE = 40
# [dist]'s decode on a key-split cache: gemma-2b's widths, B and T as in
# [decode_seq_split], pos at the end, mid-cache and SEQ_ONE
KEY_SPLIT = dict(arch="gemma-2b", B=4, T=32768)

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
    [(4, 16, 8, 64, 64, pos, 0) for pos in (0, 1, 31, 32, 62, 63)] + \
    [(4, 32, 32, 96, 64, 63, 0), (4, 24, 24, 64, 64, 63, 0),   # phi-3, musicgen
     (4, 24, 2, 128, 64, 63, 4096)] + \
    [(4, 24, 2, 128, 4096, pos, 4096)            # starcoder2's wrapped ring
     for pos in (4095, 8192, 8192 + PAST_STEPS - 1)]

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
# the [family_*] phases' shapes: starcoder2's, phi-3-vision's and musicgen's
# training (B=4, S=1024; starcoder2's window longer than S), and
# starcoder2's [past_window] prefill at twice its window (B=1, as held there)
FLASH_STARCODER2 = dict(B=4, S=1024, H=24, Hkv=2, D=128)
FLASH_PHI3V = dict(B=4, S=1024, H=32, Hkv=32, D=96)
FLASH_MUSICGEN = dict(B=4, S=1024, H=24, Hkv=24, D=64)
FLASH_WINDOW = dict(B=4, S=8192, H=24, Hkv=2, D=128, window=4096)
FLASH_FAMILIES = [(4, 1024, 24, 2, 128, 4096), (4, 1024, 32, 32, 96, 0),
                  (4, 1024, 24, 24, 64, 0), (1, 8192, 24, 2, 128, 4096)]
# granite-moe-1b-a400m's training shape (G=2, D=64)
FLASH_GRANITE = dict(B=4, S=1024, H=16, Hkv=8, D=64)
# MLA's training shape at deepseek-v3's widths: 128 heads, QK dim 128 + 64,
# V padded up to it; timed as a yardstick (MLA trains through the plain
# blockwise_attention, as in JAX)
FLASH_MLA = dict(B=4, S=1024, H=128, Hkv=128, D=192)
# one absorbed MLA decode layer timed as a yardstick: batch 4, a 32k cache
MLA_DECODE = dict(B=4, T=32768)
# the [prefill] phase: full-width gemma-2b over prefill_32k's length (its
# batch of 32 cut to 4 to fit one card), then 8 decode steps from its cache;
# the fp32 check of that continuation at batch 1; the kernel against the
# plain impls at 4096 tokens
PREFILL = dict(B=4, S=32768)
PREFILL_STEPS = 8
PREFILL_IMPLS_S = 4096
# the flash kernel at the [prefill] phase's shape, and the blocks of query
# rows held against the plain version there: the first, a middle, the last
FLASH_PREFILL = dict(B=4, S=32768, H=8, Hkv=1, D=256)
FLASH_PREFILL_ROWS = ((0, 512), (16128, 16640), (32256, 32768))
# ref_attention materializes B*H*S*T fp32 scores; past this S (2.1 GB of
# them at B=4, H=8) the plain version timed is blockwise_attention
PLAIN_MAX_S = 4096

# the decode and flash kernels each input dtype runs, as the profiler names
# them (a decode call of more than one split also runs the combine)
DECODE_ROUTES = {torch.bfloat16: "decode_mma_kernel",
                 torch.float32: "decode_simt_kernel"}
DECODE_COMBINE = "decode_combine_kernel"
FLASH_ROUTES = {torch.bfloat16: "flash_fwd_mma_kernel",
                torch.float32: "flash_fwd_kernel"}
# the decode shapes timed (B, H, Hkv, D, T, pos): gemma-2b's widths at the
# served cache and longer ones, then zamba2-2.7b's shared block and
# granite-moe-1b-a400m's attention as served, starcoder2-3b's wrapped ring of
# 4096 at [past_window]'s last step, phi-3-vision's and musicgen's served
DECODE_TIMED = [(4, 8, 1, 256, T, T - 1) for T in (64, 1024, 4096, 32768)] + \
    [(4, 32, 32, 80, 64, 63), (4, 16, 8, 64, 64, 63)] + \
    [(4, 24, 2, 128, 4096, 8192 + PAST_STEPS - 1),   # starcoder2's full ring
     (4, 32, 32, 96, 64, 63), (4, 24, 24, 64, 64, 63)]   # phi-3, musicgen
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
    """A phase's line; ``t_s``, the seconds since the script started, clocks
    the phases."""
    fields["t_s"] = time.perf_counter() - T_START
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _attention_layers(cfg) -> int:
    """Attention layers a token passes through a kernel: every layer of a
    dense model, none in mamba2 or with MLA (plain ops, as in JAX),
    zamba2's shared block once per period."""
    if cfg.family == "ssm" or cfg.attention == "mla":
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
    with no combine.  The partial entry over the same valid keys gives the
    same output bit for bit (the launch with an lse pointer against the one
    without), and its lse within the fp32 ``TOL`` of the plain one's, on
    the one-split route and through the combine."""
    errors, routes, n_sm = {}, {}, torch.cuda.get_device_properties(0) \
        .multi_processor_count
    lse_err = 0.0
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
            part, lse = decode_attention_partial(q, k, v, limit=min(pos + 1, T))
            lse_want = decode_attention_partial_ref(q, k, v,
                                                    limit=min(pos + 1, T))[1]
            lse_diff = (lse - lse_want).abs()
            lse_err = max(lse_err, lse_diff.max().item())
            if not torch.equal(part, got) or not bool(
                    (lse_diff <= TOL[torch.float32] * (1 + lse_want.abs())
                     ).all()):
                raise AssertionError(
                    f"the partial entry at {name} differs from the launch "
                    f"without lse, or its lse from plain by "
                    f"{lse_diff.max().item()}")
            del q, k, v, got, want, want32, diff, diff32, part, lse, lse_want
        routes[str(dtype)[6:]] = sorted(ran)
    _say("kernel_vs_plain", cases=len(errors), max_abs_err=max(errors.values()),
         routes=routes, partial_bit_equal=True, partial_lse_max_abs_err=lse_err,
         errors=errors)
    return errors


def _slices(q, k, v, pos: int, n: int):
    """The partial entry on each of ``n`` contiguous key slices of the
    caches, each with its share of the ``min(pos + 1, T)`` valid keys, as
    ``sharding.split_call`` gives a rank its own -> (outs, lses, limits,
    the slices)."""
    T = k.shape[1]
    T_loc, valid = T // n, min(pos + 1, T)
    outs, lses, limits, parts = [], [], [], []
    for r in range(n):
        limit = slice_limit(valid, r * T_loc, T_loc)
        ks, vs = (t[:, r * T_loc:(r + 1) * T_loc].contiguous()
                  for t in (k, v))
        out, lse = decode_attention_partial(q, ks, vs, limit=limit)
        outs.append(out)
        lses.append(lse)
        limits.append(limit)
        parts.append((ks, vs))
    return outs, lses, limits, parts


def _close(got, ref, tol: float) -> bool:
    """``got`` finite and within ``tol`` of ``ref``'s largest magnitude plus
    ``tol`` of each element's: attention over thousands of random keys gives
    outputs of a few thousandths, which an absolute ``tol`` would not hold."""
    diff = (got - ref).abs()
    return bool(torch.isfinite(got).all()) and bool(
        (diff <= tol * ref.abs().max() + tol * ref.abs()).all())


def decode_seq_split(card: str):
    """``[decode_seq_split]``: the decode cache split over its keys, each
    slice through the partial entry, merged by log-sum-exp (the mesh
    path's ``merge_partials``).  Each slice's out against the plain
    partial's by :func:`_close` at ``TOL`` and its lse at the fp32 ``TOL``;
    the merged result by :func:`_close` at ``TOL`` against the whole-cache
    kernel and the plain version, and the gate shown to refuse the merge of
    every slice's out off by 30%.  At pos ``T // 2 + SEQ_ONE`` the partly
    valid slice runs on the one-split route.  Launches counted on the
    merged path only (one a slice with a valid key, none on an empty one).
    One full slice of each width timed in bf16 against its byte bound ->
    (launches, max error, timings)."""
    t0 = time.perf_counter()
    launches, errors, lse_err, timed = 0, {}, 0.0, []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda")
    for width, c in SEQ_WIDTHS.items():
        B, H, Hkv, D, T = (c[n] for n in ("B", "H", "Hkv", "D", "T"))
        gen.manual_seed(7)
        base = [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in base)
            tol = TOL[dtype]
            for pos in (T - 1, T // 2 + SEQ_MID, T // 2 + SEQ_ONE):
                whole = decode_attention(q, k, v, pos=pos).float()
                plain = decode_attention_ref(q, k, v, pos=pos).float()
                for n in SEQ_SPLITS:
                    name = f"{width} {str(dtype)[6:]} pos{pos} {n} slices"
                    _reset_counts()
                    outs, lses, limits, parts = _slices(q, k, v, pos, n)
                    got = merge_partials(torch.stack(outs), torch.stack(lses)
                                         ).to(dtype).float()
                    counts = _counts()
                    valid = sum(1 for lim in limits if lim)
                    _check_counts(counts, {"decode_attention": valid},
                                  f"decode_seq_split {name}")
                    launches += valid
                    partly = [lim for lim in limits if 0 < lim < T // n]
                    if pos != T - 1 and not (0 in limits and partly):
                        raise AssertionError(f"pos {pos} leaves no empty and "
                                             f"partly valid slice: {limits}")
                    if pos == T // 2 + SEQ_ONE and da_ops.plan(
                            B, H, Hkv, D, partly[0], n_sm, dtype).n_split != 1:
                        raise AssertionError(f"{name}: {partly[0]} keys are "
                                             f"planned in more than one split")
                    for r, (ks, vs) in enumerate(parts):
                        want_out, want = decode_attention_partial_ref(
                            q, ks, vs, limit=limits[r])
                        if limits[r] == 0:
                            ok = bool((lses[r] == -math.inf).all()) and \
                                not outs[r].any()
                        else:
                            d = (lses[r] - want).abs()
                            lse_err = max(lse_err, d.max().item())
                            ok = bool((d <= TOL[torch.float32] * (
                                1 + want.abs())).all()) and _close(
                                outs[r].float(), want_out.float(), tol)
                            key = f"{name}, each slice vs plain"
                            errors[key] = max(errors.get(key, 0.0), (
                                outs[r].float() - want_out.float()
                            ).abs().max().item())
                        if not ok:
                            raise AssertionError(
                                f"out or lse of slice {r} of {name} "
                                f"disagrees with plain")
                    for ref_name, ref in (("kernel", whole), ("plain", plain)):
                        errors[f"{name} vs {ref_name}"] = \
                            (got - ref).abs().max().item()
                        if not _close(got, ref, tol):
                            raise AssertionError(
                                f"merged slices disagree with the {ref_name} "
                                f"at {name}: max|err| "
                                f"{errors[f'{name} vs {ref_name}']}")
                    off = merge_partials(torch.stack(outs).float() * 1.3,
                                         torch.stack(lses))
                    if _close(off, plain, tol):
                        raise AssertionError(f"the gate at {name} passes "
                                             f"every slice's P.V off by 30%")
                    del outs, lses, parts
        # one full slice of the 16-way cut, bf16, timed against its bound
        q, k, v = (t.to(torch.bfloat16) for t in base)
        T_loc = T // SEQ_SPLITS[-1]
        ks, vs = (t[:, :T_loc].contiguous() for t in (k, v))
        ops, nbytes = da_ops.costs(q, ks, T_loc)
        shape = (f"{width}: B={B} H={H} Hkv={Hkv} D={D} slice of {T_loc} "
                 f"keys, all valid, bf16")
        timed.append({
            "shape": shape,
            "ms": device_ms(lambda: decode_attention_partial(
                q, ks, vs, limit=T_loc)),
            "whole_slice_ms": device_ms(lambda: decode_attention(
                q, ks, vs, pos=T_loc - 1)),
            "plain_ms": device_ms(lambda: decode_attention_partial_ref(
                q, ks, vs, limit=T_loc)),
            "library_ms": device_ms(lambda: library_call(q, ks, vs,
                                                         T_loc - 1)),
            **_bound("decode_attention_partial", shape, nbytes, ops,
                     FP32_OPS_PER_S, card),
            "card": card})
        del base, q, k, v, ks, vs
        torch.cuda.empty_cache()
    _say("decode_seq_split", launches=launches,
         max_abs_err=max(errors.values()), lse_max_abs_err=lse_err,
         tol={str(k)[6:]: t for k, t in TOL.items()},
         tol_of="the reference's largest magnitude, plus relative",
         refuses_pv_off_by_30pct=True, timed=timed,
         phase_s=time.perf_counter() - t0, errors=errors)
    return launches, max(errors.values()), timed


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
                + [tuple(FLASH_GRANITE.values()) + (0,),
                   tuple(FLASH_MLA.values()) + (0,)] + FLASH_FAMILIES:
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


def flash_prefill_vs_plain():
    """The flash kernel at the [prefill] phase's shape (``FLASH_PREFILL``,
    bf16, causal) against the plain ``blockwise_attention`` (the ``torch``
    impl; ``ref_attention`` would materialize 137 GB of scores) on the
    blocks of query rows ``FLASH_PREFILL_ROWS``, each with its keys up to the
    block's end and its rows' offset, under ``flash_vs_plain``'s two gates."""
    B, S, H, Hkv, D = FLASH_PREFILL.values()
    q, k, v = _flash_inputs(B, S, H, Hkv, D, torch.bfloat16, seed=3)
    got, names = _profiled(lambda: flash_attention(q, k, v), "flash_fwd")
    route = FLASH_ROUTES[torch.bfloat16]
    if not names or not all(route in n for n in names):
        raise AssertionError(f"flash at {FLASH_PREFILL} ran {names}")
    errors, errors32 = {}, {}
    tol, half_ulp = TOL[torch.bfloat16], 2.0 ** -8
    for r0, r1 in FLASH_PREFILL_ROWS:
        def plain(dtype):
            return attn_lib.blockwise_attention(
                q[:, r0:r1].to(dtype), k[:, :r1].to(dtype), v[:, :r1].to(dtype),
                scale=1.0 / math.sqrt(D), q_offset=r0).float()
        rows = got[:, r0:r1].float()
        want, want32 = plain(torch.bfloat16), plain(torch.float32)
        diff, diff32 = (rows - want).abs(), (rows - want32).abs()
        name = f"bf16 B{B} S{S} H{H} Hkv{Hkv} D{D} rows {r0}-{r1}"
        errors[name], errors32[name] = diff.max().item(), diff32.max().item()
        if not (bool((diff <= tol + tol * want.abs()).all())
                and bool((diff32 <= TOL[torch.float32]
                          + half_ulp * want32.abs()).all())
                and bool(torch.isfinite(rows).all())):
            raise AssertionError(
                f"flash kernel disagrees with plain at {name}: max|err| "
                f"{errors[name]}, against fp32 {errors32[name]}")
    _say("flash_prefill_vs_plain", shape=FLASH_PREFILL, routes=sorted(names),
         errors=errors, errors_against_fp32=errors32)
    del q, k, v, got
    torch.cuda.empty_cache()
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
def _server(job: ServeJob, layers=None, params=None) -> Server:
    """A ``Server`` for ``job``.  With ``layers``, its model is cut to the
    first ``layers`` layers after construction, as ``examples/train_lm.py``
    overrides a job's config, and it is given params drawn for the cut model
    from the job's seed (or ``params``), so that it draws no full-depth
    tree."""
    if layers is None:
        return Server(job, params=params)
    cfg = _cut(get_arch(job.arch), layers)
    if params is None:
        params = build_model(cfg).init(
            torch.Generator("cuda").manual_seed(job.seed), "cuda")
    srv = Server(job, params=params)
    srv.cfg, srv.model = cfg, build_model(cfg)
    return srv


def _cut(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` layers: an MoE model's leading
    dense layers too, where the cut leaves fewer."""
    if cfg.moe is not None and cfg.moe.first_dense_layers > layers:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                first_dense_layers=layers))
    return cfg.with_(num_layers=layers)


def _cut_trainer(trainer: Trainer, layers: int) -> None:
    """The trainer's model cut to its first ``layers`` layers after
    construction, before it draws any params."""
    job = trainer.job
    trainer.cfg = _cut(trainer.cfg, layers)
    trainer.model = build_model(trainer.cfg)
    trainer.step_fn = steps_lib.make_train_step(
        trainer.model, trainer.opt, microbatches=job.microbatches,
        grad_compress=job.grad_compress)


def _reduced(cfg) -> dict:
    """The depth cut of ``cfg`` against its published config, for a phase's
    line (the script cuts nothing else)."""
    full = get_arch(cfg.name).num_layers
    return {"num_layers": [full, cfg.num_layers]} \
        if full != cfg.num_layers else {}


def serve(card: str, arch: str, layers=None, tag: str = "serve",
          second: bool = True):
    """``Server.generate`` on full-width ``arch`` (its depth cut to
    ``layers`` if given): batch 4, 32 prompt + 32 new tokens, greedy; the
    output is checked, a second server gives the same tokens (unless not
    ``second``), and the decode kernel is launched once per attention layer
    and token that goes through it (never with MLA).  A model with
    codebooks, which ``Server.generate`` does not take (its prompts are
    (B, P), as JAX's), is served by :func:`_codebook_generate` from the
    server's params: (B, K, 32) prompts prefilled, the flash kernel once
    per layer, then 32 decode steps.  Then the family's comparison: for a
    model with GQA attention, the served positions through the decode
    kernel and through plain attention (held in the served dtype for the
    dense family, in fp32 for the others); for mamba2, which decodes
    through no kernel, its decode logits against the train forward's
    through the ssd kernel; MLA's comparison is
    ``mla_decode_vs_forward``."""
    job = ServeJob(arch=arch, smoke=False, batch=4, prompt_len=32,
                   max_new_tokens=32)
    torch.cuda.reset_peak_memory_stats()
    srv = _server(job, layers)
    cfg = srv.cfg
    K = cfg.num_codebooks
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (job.batch,) + ((K,) if K else ())
        + (job.prompt_len,)).astype(np.int32)
    total = job.prompt_len + job.max_new_tokens

    _reset_counts()
    out = _generate(srv, prompts)
    counts = _counts()

    if out.shape != prompts.shape[:-1] + (total,):
        raise AssertionError(f"{arch}: output shape {out.shape}")
    if not (out[..., :job.prompt_len] == prompts).all():
        raise AssertionError(f"{arch}: prompt not preserved")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: token id out of vocab")
    L = _attention_layers(cfg)
    _check_counts(counts, {"flash_attention": L,
                           "decode_attention": L * job.max_new_tokens}
                  if K else {"decode_attention": L * total}, arch)
    first = dict(srv.stats, tokens_per_s=srv.throughput())

    second_stats = None
    if second:
        again = _server(job, layers, srv.params if layers else None)
        if not np.array_equal(out, _generate(again, prompts)):
            raise AssertionError(f"{arch}: a second Server gave other tokens")
        second_stats = dict(again.stats, tokens_per_s=again.throughput())
        del again

    held = cfg.dtype if cfg.family == "dense" else "float32"
    if cfg.family == "ssm":
        check = "decode vs the train forward through the ssd kernel"
        rel, steps = _decode_vs_forward(srv, 512), 512
    elif cfg.attention == "mla":
        check, rel, steps = "in [mla_decode_vs_forward]", None, None
    else:
        check = "decode kernel vs torch attention"
        rel, steps = _decode_kernel_vs_torch(srv, out, held), total
    prefill = (_prefill_vs_decode(srv, out, held) if cfg.attention != "mla"
               else "in [mla_decode_vs_forward]")
    srv.served = (prompts, out)      # the [dist] phase serves them again
    srv.launches = counts
    _say(tag, card=card, arch=cfg.name, layers=cfg.num_layers,
         reduced=_reduced(cfg),
         d_model=cfg.d_model, batch=job.batch, prompt_len=job.prompt_len,
         new_tokens=job.max_new_tokens, codebooks=K, launches=counts,
         path="make_prefill_step + make_decode_step" if K
         else "Server.generate",
         first_server=first, second_server=second_stats, check=check,
         check_rel=rel, check_steps=steps, prefill_vs_decode=prefill,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         sample=out[0, ..., job.prompt_len:job.prompt_len + 8].tolist())
    return srv, counts["decode_attention"]


def _generate(srv, prompts: np.ndarray) -> np.ndarray:
    """``srv.generate(prompts)``, or for a model with codebooks
    :func:`_codebook_generate`."""
    if srv.cfg.num_codebooks:
        return _codebook_generate(srv, prompts)
    return srv.generate(prompts)


def _codebook_generate(srv, prompts: np.ndarray) -> np.ndarray:
    """Greedy generation for a model with codebooks, as ``Server.generate``
    runs it for text, on the server's params, head and stats: prompts
    (B, K, P) through ``make_prefill_step`` (the flash kernel once per
    layer), the cache padded to P + new, then ``max_new_tokens`` steps of
    ``make_decode_step``, each codebook's next token the argmax of its
    logits -> (B, K, P + new)."""
    job, model, V = srv.job, srv.model, srv.cfg.vocab_size
    B, K, P = prompts.shape
    total = P + job.max_new_tokens
    out = np.zeros((B, K, total), np.int32)
    out[..., :P] = prompts
    t0 = time.perf_counter()
    logits, cache = steps_lib.make_prefill_step(model)(
        srv.params, {"tokens": torch.from_numpy(prompts).to(srv.device,
                                                            torch.int64)},
        head=srv.head)
    cache = _pad_cache(model, cache, B, total)
    srv._sync()
    srv.stats["prefill_s"] += time.perf_counter() - t0
    step = steps_lib.make_decode_step(model)
    t0 = time.perf_counter()
    for t in range(P, total):
        tok = logits[..., :V].argmax(-1)                    # (B, K)
        out[..., t] = tok.cpu().numpy()
        logits, cache = step(srv.params, cache, tok, t, head=srv.head)
    srv._sync()
    srv.stats["decode_s"] += time.perf_counter() - t0
    srv.stats["tokens"] += B * job.max_new_tokens
    return out


def _decode_kernel_vs_torch(srv, out, held: str) -> dict:
    """The served tokens at the served positions, on a cache of the served
    length, through the decode kernel and through plain attention: the
    largest difference over the vocabulary's real slots relative to the
    largest logit, in the served dtype and in ``held`` (the served weights
    cast to fp32 for "float32").  Held at ``DECODE_RTOL`` in ``held`` only,
    which ``serve`` makes fp32 for every family but dense: zamba2's 54 mamba
    layers of random weights carry bf16's rounding of the attention output
    forward to several times that, and in granite a bf16 rounding can flip
    an expert choice downstream (``PERF.md`` §7: JAX's two impls differ as
    much), where gemma-2b's 18 dense layers do neither; so gemma-2b is held
    in bf16, the others in fp32 with their bf16 reported."""
    cfg = srv.cfg
    rels = {}
    for dtype in dict.fromkeys((held, cfg.dtype)):
        params = (srv.params if dtype == cfg.dtype
                  else tree_map(lambda p: p.float(), srv.params))
        logits = {}
        with torch.inference_mode():
            for impl in ("torch", "kernel"):
                model = build_model(cfg.with_(dtype=dtype), attn_impl=impl)
                cache = model.init_cache(out.shape[0], out.shape[-1],
                                         srv.device)
                per_step = []
                for t in range(out.shape[-1]):
                    tok = torch.from_numpy(out[..., t]).to(srv.device,
                                                           torch.int64)
                    lg, cache = model.decode_step(params, cache, tok, t,
                                                  head=srv.head)
                    per_step.append(lg[..., :cfg.vocab_size].float())
                logits[impl] = torch.stack(per_step)
        if not torch.isfinite(logits["kernel"]).all():
            raise AssertionError("non-finite logits")
        rels[dtype] = max(((logits["kernel"][t] - logits["torch"][t])
                           .abs().max() / logits["torch"][t].abs().max()).item()
                          for t in range(out.shape[-1]))
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


def _pad_cache(model, cache, batch: int, length: int):
    """A prefill cache zero-padded, leaf by leaf, to the shapes of
    ``model.cache_specs(batch, length)``: along the time axes of the global
    caches and of local ones shorter than their window (the SSM state and
    conv tail have none).  In inference mode, where a prefill's cache was
    made and may be written."""
    def pad(leaf, spec):
        out = leaf.new_zeros(spec.shape)
        out[tuple(slice(0, n) for n in leaf.shape)] = leaf
        return out
    with torch.inference_mode():
        return tree_map(pad, cache, model.cache_specs(batch, length))


def _rel_rows(got, want) -> float:
    """The largest difference relative to the largest |want|, row by row
    (a row: one sequence's logits at one position), the largest of those."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    return ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()


def _prefill_vs_decode(srv, out, held: str) -> dict:
    """The served tokens prefilled, then continued by decode, against the
    served decode: the prompt through ``make_prefill_step`` (the flash kernel
    once per attention layer, the ssd kernel never: the mamba layers scan
    through the plain ``ssd_chunked``, as in JAX), its last logits against
    the served decode's at the prompt's last position; its cache padded to
    the served length, and the new tokens through ``make_decode_step``
    against the served decode's logits at their positions.  On the served
    weights in ``held`` (cast up for "float32", as
    ``_decode_kernel_vs_torch`` holds each family), with the served head;
    a moe model at its dropless capacity factor 16 in both (at 1.25 a
    prefill of 4 x 32 tokens drops assignments that decode at 4 does not),
    its served decode taken again so.  Held at ``DECODE_RTOL``."""
    cfg = srv.cfg.with_(dtype=held)
    if cfg.moe:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = (srv.params if held == srv.cfg.dtype
              else tree_map(lambda p: p.float(), srv.params))
    model, V = build_model(cfg), cfg.vocab_size
    B, total = out.shape[0], out.shape[-1]
    P = srv.job.prompt_len
    tokens = torch.from_numpy(out).to(srv.device, torch.int64)
    with torch.inference_mode():
        cache = model.init_cache(B, total, srv.device)
        served = []
        for t in range(total):
            lg, cache = model.decode_step(params, cache, tokens[..., t], t,
                                          head=srv.head)
            served.append(lg[..., :V].float())
        del cache
    got, flash, decode = _continue(model, params, tokens, P, srv.head)
    _check_counts(flash, {"flash_attention": _attention_layers(cfg)},
                  f"{cfg.name} prefill")
    _check_counts(decode, {"decode_attention": _attention_layers(cfg)
                           * (total - P)}, f"{cfg.name} decode from prefill")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    rel = {"dtype": held, "prefill_last": _rel_rows(got[0], served[P - 1]),
           "continuation": _rel_rows(got[1:], torch.stack(served[P:]))}
    if not max(rel["prefill_last"], rel["continuation"]) < DECODE_RTOL:
        raise AssertionError(f"{cfg.name} prefill vs decode: {rel}")
    del params, served, got
    return rel


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


def _loss_and_grads(model, params, batch):
    """(loss, metrics, gradients of every leaf; zeros for a leaf the loss
    does not reach, as ``make_train_step`` gives them)."""
    paths, leaves = zip(*named_leaves(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = model.loss_fn(unflatten(zip(paths, leaves)), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, grads


def _grad_norm(grads, chunk: int = 1 << 26) -> float:
    """The global norm in fp32, over pieces of at most ``chunk`` elements:
    one MoE layer's expert gradients are 3.8e9 elements a leaf, whose fp32
    square would not fit beside the gradients."""
    return math.sqrt(sum(piece.float().square().sum().item() for g in grads
                         for piece in g.reshape(-1).split(chunk)))


def loss_and_grad_norm(model, params, batch):
    loss, _, grads = _loss_and_grads(model, params, batch)
    return loss.item(), _grad_norm(grads)


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
          data_ds=None, layers=None, checkpoint: bool = True):
    """``Trainer.run`` on ``job`` (its model cut to ``layers`` layers if
    given), then its gates: finite, falling losses; exact launch counts; a
    checkpoint restored bit for bit (with ``checkpoint``; else the trainer's
    save is skipped, ``_NoSave``); one batch's loss and gradient norm
    through the kernels and the plain impls within ``TRAIN_RTOL``."""
    torch.cuda.reset_peak_memory_stats()
    ckpt = (_TimedCheckpoints if checkpoint else _NoSave)(
        MemoryProvider(), keep=job.keep_checkpoints)
    trainer = Trainer(job, ckpt=ckpt, data_ds=data_ds)
    if layers is not None:
        _cut_trainer(trainer, layers)
    cfg = trainer.cfg
    step_fn, per_step = trainer.step_fn, []

    def recorded(state, batch):     # each step's metrics, read as the
        state, metrics = step_fn(state, batch)     # trainer reads its loss
        per_step.append({k: float(v) for k, v in metrics.items()})
        return state, metrics
    trainer.step_fn = recorded

    _reset_counts()
    out = trainer.run(restore=False)
    counts = _counts()
    trainer.step_fn = step_fn

    losses = [h["loss"] for h in out["history"]]
    if len(losses) != job.steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    _check_counts(counts, train_launches(cfg, job.steps), tag)
    peak_gb = trainer.peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = out["state"]
    if ckpt.saved_steps != [job.steps]:
        raise AssertionError(f"checkpoints {ckpt.saved_steps}")
    host_peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    restore_s = None
    if checkpoint:
        t0 = time.perf_counter()
        back = ckpt.restore(abstract(train_state_specs(trainer.model,
                                                       trainer.opt)),
                            device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mine, theirs = dict(named_leaves(state)), dict(named_leaves(back))
        if mine.keys() != theirs.keys() or not all(
                mine[k].dtype == theirs[k].dtype
                and torch.equal(mine[k], theirs[k]) for k in mine):
            raise AssertionError("the restored checkpoint differs from the "
                                 "state")
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
        extra = {k: metrics[k].item() for k in ("aux", "ce", "mtp")
                 if k in metrics}

    step_s = statistics.median(h["sec"] for h in out["history"][1:])
    tokens = job.global_batch * job.seq_len
    _say(tag, card=card, arch=cfg.name, layers=cfg.num_layers,
         reduced=_reduced(cfg), d_model=cfg.d_model, dtype=cfg.dtype,
         remat=cfg.remat, moment_dtype=trainer.opt.moment_dtype,
         batch=job.global_batch, seq_len=job.seq_len, steps=job.steps,
         warmup=job.warmup, lr=job.lr, launches=counts,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         step_s=[h["sec"] for h in out["history"]], median_step_s=step_s,
         tokens_per_s=tokens / step_s, peak_memory_gb=peak_gb,
         state_gb=state_gb, checkpoint=checkpoint,
         save_s=ckpt.copy_s + ckpt.write_s if checkpoint else None,
         save_copy_s=ckpt.copy_s if checkpoint else None,
         save_write_s=ckpt.write_s if checkpoint else None,
         restore_s=restore_s, host_peak_gb=host_peak_gb,
         kernel_vs_torch=compare, kernel_vs_torch_rel=rel,
         metrics_by_step=per_step, **extra)
    return trainer, state, batch, counts


class _NoSave(CheckpointManager):
    """A checkpoint manager that records each save's step and saves
    nothing: no copy to the host, no write into the lake."""

    def save(self, state, step, **kw):
        self.saved_steps.append(step)


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


# ----------------------------------------------------------------- phase 5a
def _quantized_mean_numpy(x: np.ndarray) -> np.ndarray:
    """JAX's ``quantized_psum`` over one shard, in numpy fp32: the scale
    ``(absmax + 1e-12) / 127``, values rounded half to even and clipped to
    +-127, then ``total * (scale_sum / n) / n`` with n = 1."""
    scale = np.float32(np.abs(x).max() + np.float32(1e-12)) / np.float32(127)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int32)
    return (q.astype(np.float32) * (scale / np.float32(1))) / np.float32(1)


class _Unwritten(CheckpointManager):
    """A checkpoint manager whose ``save`` gathers the state and copies it
    to the host, as any save does, but writes nothing into the lake: the
    [dist] phase restores [train]'s checkpoint instead of a 25 GB one of
    its own."""

    def _write(self, leaves, step):
        self.saved_steps.append(step)


@contextlib.contextmanager
def _world_of_one():
    """An NCCL process group of one rank on card 0, from a ``HashStore`` (no
    port), destroyed on leaving, so the phases after it run meshless."""
    import torch.distributed as tdist
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        tdist.destroy_process_group()


def dist_restore(ckpt, state) -> dict:
    """[dist]'s elastic restore, run while ``state`` is still the one
    ``ckpt`` saved (the phases after [train] train on it in place): the
    checkpoint [train] saved without a mesh restored onto the (1, 1) mesh
    of an NCCL world of one, every leaf bit for bit ``state`` ([train]
    itself holds the restore without a mesh).  -> its seconds."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.steps import state_placements
    t_phase = time.perf_counter()
    with _world_of_one():
        trainer = Trainer(TRAIN_JOB)
        mesh = trainer.mesh
        t0 = time.perf_counter()
        back = ckpt.restore(
            abstract(train_state_specs(trainer.model, trainer.opt)),
            device="cuda", mesh=mesh, shardings=state_placements(
                trainer.model, trainer.opt, mesh, trainer.rules))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want, got = dict(named_leaves(state)), dict(named_leaves(back))
        exact = got.keys() == want.keys() and all(
            isinstance(t, DTensor) and t.to_local().dtype == want[k].dtype
            and torch.equal(t.to_local(), want[k]) for k, t in got.items())
        del back, got, want, trainer
    torch.cuda.empty_cache()
    if not exact:
        raise AssertionError("[dist] [train]'s checkpoint restored onto the "
                             "mesh differs from [train]'s state")
    return {"restore_s": restore_s, "s": time.perf_counter() - t_phase}


def _key_split_placements(mesh, shape, axes):
    """The placements ``--seq-shard``'s rules give a cache of ``shape`` and
    logical ``axes`` on ``mesh``, with each split the rules name kept on its
    mesh dim even where that dim has size 1 (``placements_for`` would make
    it whole there), so that the key-split route runs on any mesh."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (make_rules, mesh_axis_names,
                                                  spec_for)
    spec = spec_for(shape, axes, mesh, make_rules("decode", seq_shard="model"))
    names = mesh_axis_names(mesh)
    pl = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            pl[names.index(a)] = Shard(dim)
    if Shard(1) not in pl:
        raise AssertionError(f"--seq-shard's rules leave the keys whole: "
                             f"{spec}")
    return pl


def _every_rank(ok: bool, device) -> bool:
    """``ok`` on every rank of the process group (``ok`` without one): a
    check that fails on one rank fails on all, so that none goes on to
    collectives the others never join."""
    import torch.distributed as tdist
    if not tdist.is_initialized():
        return bool(ok)
    flag = torch.tensor([int(bool(ok))], device=device)
    tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
    return bool(flag.item())


def key_split_decode(mesh, device: str = "cuda", T: int = KEY_SPLIT["T"]
                     ) -> dict:
    """``gqa_decode`` at ``KEY_SPLIT``'s widths on ``mesh`` (one rank or
    more), its caches placed as ``--seq-shard``'s rules place them
    (:func:`_key_split_placements`): so the key-split route runs,
    ``split_call`` with the partial entry on ``local_call``'s shards and the
    merge's all-reduces.  Random bf16 weights and inputs from a seed, the
    same on every rank; per pos (the end, mid-cache, ``SEQ_ONE``), one
    launch on each rank whose slice holds a valid key, the output within :func:`_close` at the bf16 ``TOL`` of
    the meshless ``gqa_decode``'s on the whole cache and the caches equal
    to its -> {launches, max_abs_err}."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import distribute
    cfg = get_arch(KEY_SPLIT["arch"])
    B = KEY_SPLIT["B"]
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device).manual_seed(11)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device)
    params = {n: (rand(*sp.shape) / math.sqrt(sp.shape[0])).to(torch.bfloat16)
              for n, sp in attn_lib.gqa_specs(cfg).items()}
    x = rand(B, 1, cfg.d_model).to(torch.bfloat16)
    cache = [rand(B, T, Hkv, D).to(torch.bfloat16) for _ in range(2)]
    pl = _key_split_placements(mesh, (B, T, Hkv, D),
                               ("batch", "seq", "heads", None))
    launches, err = 0, 0.0
    for pos in (T - 1, T // 2 + SEQ_MID, SEQ_ONE):
        ck, cv = (distribute(c.clone(), mesh, pl) for c in cache)
        wk, wv = (c.clone() for c in cache)
        with torch.no_grad():
            want, wk, wv = attn_lib.gqa_decode(params, x, wk, wv, pos, cfg)
            _reset_counts()
            with implicit_replication():
                got, ck, cv = attn_lib.gqa_decode(params, x, ck, cv, pos, cfg)
            got = got.full_tensor()
            counts = _counts()
        # a rank whose slice holds no valid key launches nothing
        mine = slice_limit(pos + 1, *_local_range(ck, 1))
        want_launches = int(mine > 0 and torch.device(device).type == "cuda")
        launches += want_launches
        err = max(err, (got.float() - want.float()).abs().max().item())
        ok = counts == {**dict.fromkeys(COUNTED, 0),
                        "decode_attention": want_launches} and \
            _close(got.float(), want.float(), TOL[torch.bfloat16]) and \
            torch.equal(ck.full_tensor(), wk) and \
            torch.equal(cv.full_tensor(), wv)
        if not _every_rank(ok, device):
            raise AssertionError(f"decode on a key-split cache at pos {pos}: "
                                 f"launches {counts} (want {want_launches} "
                                 f"here), off the meshless decode by {err}")
        del ck, cv, wk, wv, got, want
    return {"launches": launches, "max_abs_err": err,
            "placements": str(tuple(pl))}


def mla_key_split_decode(mesh, device: str = "cuda",
                         T: int = MLA_DECODE["T"]) -> dict:
    """One ``mla_decode`` layer at full deepseek-v3 widths on ``mesh``, in
    fp32, its latent caches (B=4, T) placed as ``--seq-shard``'s rules place
    them (:func:`_key_split_placements`): each rank's absorbed partial over
    its slice (``mla_decode_partial``), merged by log-sum-exp before W_uv.
    Random weights and inputs from a seed, the same on every rank; per pos
    (the end, mid-cache, ``SEQ_ONE``) the output within :func:`_close` at
    the fp32 ``TOL`` of the meshless ``mla_decode``'s on the whole caches,
    the caches equal to its, and no kernel launched (MLA decodes in plain
    ops, as in JAX) -> {max_abs_err, placements}."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import distribute
    cfg = get_arch(DEEPSEEK)
    m, B = cfg.mla, MLA_DECODE["B"]
    gen = torch.Generator(device).manual_seed(12)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device)
    params = {n: rand(*sp.shape) / math.sqrt(sp.shape[0])
              for n, sp in attn_lib.mla_specs(cfg).items()}
    params.update({n: torch.ones(sp.shape, device=device) for n, sp in
                   attn_lib.mla_specs(cfg).items() if n.endswith("_norm")})
    x = rand(B, 1, cfg.d_model)
    cache = [rand(B, T, m.kv_lora_rank), rand(B, T, m.rope_head_dim)]
    pl = _key_split_placements(mesh, (B, T, m.kv_lora_rank),
                               ("batch", "seq", None))
    err = 0.0
    for pos in (T - 1, T // 2 + SEQ_MID, SEQ_ONE):
        ckv, kr = (distribute(c.clone(), mesh, pl) for c in cache)
        wckv, wkr = (c.clone() for c in cache)
        with torch.no_grad():
            want, wckv, wkr = attn_lib.mla_decode(params, x, wckv, wkr, pos,
                                                  cfg)
            _reset_counts()
            with implicit_replication():
                got, ckv, kr = attn_lib.mla_decode(params, x, ckv, kr, pos,
                                                   cfg)
            got = got.full_tensor()
            counts = _counts()
        err = max(err, (got - want).abs().max().item())
        ok = not any(counts.values()) and \
            _close(got, want, TOL[torch.float32]) and \
            torch.equal(ckv.full_tensor(), wckv) and \
            torch.equal(kr.full_tensor(), wkr)
        if not _every_rank(ok, device):
            raise AssertionError(f"mla decode on a key-split cache at pos "
                                 f"{pos}: launches {counts}, off the meshless "
                                 f"decode by {err}")
        del ckv, kr, wckv, wkr, got, want
    return {"max_abs_err": err, "placements": str(tuple(pl)), "T": T}


def dist(card: str, train_ref=None, served=None, restored=None):
    """[dist]: the distributed path in an NCCL world of one (one card; NCCL
    puts no two ranks on one device, so no multi-rank run is made here).
    ``restored`` is :func:`dist_restore`'s result, the elastic restore.
    Then full-width gemma-2b through ``Trainer`` on the (1, 1) mesh, as
    DTensors placed by the train rules: ``TRAIN_JOB``'s 8 lake-fed steps,
    each loss held against ``[train]``'s (``train_ref``) at the bf16
    ``TOL``, exactly 2 x 18 flash launches a step, every state leaf on the
    card, and its final save gathered to the host but not written
    (``_Unwritten``); the int8 all-reduce once over the group on one step's
    gradients in fp32, held against numpy's version of JAX's formula on four
    leaves within 1e-6 of each leaf's largest value; then
    ``Server.generate`` on the mesh from the served params' seed, whose
    greedy tokens must be ``[serve]``'s (``served``), through the decode
    kernel; :func:`key_split_decode` and :func:`mla_key_split_decode` on
    the mesh.  Without
    ``train_ref``, ``restored`` and ``served``, fresh meshless runs make
    them -> (flash launches, decode launches of the Trainer and Server,
    :func:`key_split_decode`'s result)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.collectives import (collective_wire_bytes,
                                                     make_quantized_allreduce)
    job = TRAIN_JOB
    sjob = ServeJob(arch="gemma-2b", smoke=False, batch=4, prompt_len=32,
                    max_new_tokens=32)
    if restored is None:
        torch.cuda.reset_peak_memory_stats()
        ref = Trainer(job, ckpt=CheckpointManager(MemoryProvider()))
        out = ref.run(restore=False)
        train_ref = {"losses": [h["loss"] for h in out["history"]],
                     "step_s": statistics.median(h["sec"] for h in
                                                 out["history"][1:]),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        restored = dist_restore(ref.ckpt, out["state"])
        del ref, out
    if served is None:
        srv = Server(sjob)
        prompts = np.random.default_rng(0).integers(
            0, srv.cfg.vocab_size, (sjob.batch, sjob.prompt_len)).astype(
                np.int32)
        served = (prompts, srv.generate(prompts))
        del srv
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()     # the references above not counted
    with _world_of_one():
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(job, ckpt=_Unwritten(MemoryProvider(), keep=1))
        mesh = trainer.mesh
        _reset_counts()
        out = trainer.run(restore=False)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _check_counts(counts, train_launches(trainer.cfg, job.steps), "dist")
        losses = [h["loss"] for h in out["history"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, train_ref["losses"])]
        if len(losses) != job.steps or not max(rel) <= TOL[torch.bfloat16]:
            raise AssertionError(f"[dist] losses {losses} vs [train] "
                                 f"{train_ref['losses']}")
        if trainer.ckpt.saved_steps != [job.steps]:
            raise AssertionError(f"[dist] saves {trainer.ckpt.saved_steps}")
        state = out["state"]
        if not all(isinstance(t, DTensor) and t.to_local().is_cuda
                   for _, t in named_leaves(state)):
            raise AssertionError("[dist] a state leaf is not a DTensor on "
                                 "the card")
        step_s = statistics.median(h["sec"] for h in out["history"][1:])

        # the int8 all-reduce on one step's gradients, in fp32
        batch = next(trainer._batches())
        with trainer.model.spmd():
            grads = _loss_and_grads(trainer.model, state["params"], batch)[2]
        paths = [p for p, _ in named_leaves(state["params"])]
        grads = unflatten((p, g.float()) for p, g in zip(paths, grads))
        del state, out, trainer
        allreduce = make_quantized_allreduce(mesh, "data")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduced_tree = allreduce(grads)
        torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t0) * 1e3
        ar_err = 0.0
        for path in ("blocks/attn/wq", "blocks/attn/wk", "blocks/ln1",
                     "final_ln"):
            g = dict(named_leaves(grads))[path].to_local().cpu().numpy()
            got = dict(named_leaves(reduced_tree))[path].cpu().numpy()
            err = np.abs(got - _quantized_mean_numpy(g)).max() / \
                np.abs(g).max()
            ar_err = max(ar_err, float(err))
        if not ar_err <= 1e-6:
            raise AssertionError(f"[dist] int8 all-reduce off by {ar_err}")
        wire = (collective_wire_bytes(grads, True),
                collective_wire_bytes(grads, False))
        del grads, reduced_tree, batch
        torch.cuda.empty_cache()

        # serving on the mesh from the served params' seed
        srv = Server(sjob)
        _reset_counts()
        tokens = srv.generate(served[0])
        serve_counts = _counts()
        total = sjob.prompt_len + sjob.max_new_tokens
        _check_counts(serve_counts, {"decode_attention":
                                     _attention_layers(srv.cfg) * total},
                      "dist serve")
        if not np.array_equal(tokens, served[1]):
            raise AssertionError("[dist] the mesh's greedy tokens differ "
                                 "from [serve]'s")
        tok_s = srv.throughput()
        del srv
        torch.cuda.empty_cache()
        key_split = key_split_decode(mesh)
        mla_key_split = mla_key_split_decode(mesh)
    torch.cuda.empty_cache()
    # the meshed step's peak (the vocab-parallel loss on DTensors) against
    # the meshless one's, each over Trainer.run
    _say("dist_peak", card=card, mesh=[1, 1], peak_memory_gb=peak_gb,
         train_peak_memory_gb=train_ref["peak_gb"],
         ratio=peak_gb / train_ref["peak_gb"])
    _say("dist", card=card, mesh=[1, 1], launches={
             "flash_attention": counts["flash_attention"],
             "decode_attention": serve_counts["decode_attention"]},
         loss_rel_max=max(rel), step_s=step_s, train_step_s=train_ref[
             "step_s"], allreduce_ms=ar_ms, allreduce_err=ar_err,
         wire_bytes=wire, restore_exact=True,
         restore_s=restored["restore_s"], tokens_equal=True,
         tokens_per_s=tok_s, key_split_decode=key_split,
         mla_key_split_decode=mla_key_split,
         phase_s=time.perf_counter() - t_phase + restored["s"])
    return (counts["flash_attention"], serve_counts["decode_attention"],
            key_split)


def torchrun_train(card: str) -> dict:
    """``[torchrun]``: ``python -m torch.distributed.run --standalone
    --nproc-per-node 1 -m repro_torch.launch.train`` for 2 smoke steps, the
    launch path of ``scripts/mesh_smoke.py`` on one card: the process group
    from torchrun's variables (NCCL), the rank's card, a (1, 1) mesh; the
    command exits 0 and prints its one "done:" line with that mesh."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
           "--steps", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    wall_s = time.perf_counter() - t0
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("done:")]
    if proc.returncode != 0 or len(done) != 1 or \
            not done[0].endswith("mesh=(1, 1)"):
        raise AssertionError(f"[torchrun] rc {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    _say("torchrun", card=card, command=" ".join(cmd[1:]), wall_s=wall_s,
         done=done[0])
    return {"wall_s": wall_s}


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
# the buffer's scatter, SiLU-GLU, combine), "MLA attention (plain)" all of
# ``mla_train`` (its projections and the blockwise attention, forward and
# backward), "MTP" all of ``_mtp_loss`` (its block, logits and loss), "other"
# the rest of the model (norms, rope, residuals, embeddings, copies)
TRACE_GROUPS = ("flash", "attention backward (plain)", "MLA attention (plain)",
                "ssd", "ssd backward (plain)", "MTP", "expert GEMMs", "dispatch", "logits and loss",
                "optimizer", "other GEMMs", "nccl", "other", "unattributed")
# the functions a grouped trace marks with a profiler range of their name
# (``scope:<name>``), for the time of the trace
TRACE_SCOPES = ((moe_lib, "moe_apply"), (model_lib.Model, "_dense_block"),
                (model_lib.Model, "_logits"),
                (model_lib, "softmax_cross_entropy"), (AdamW, "update"),
                (steps_lib, "apply_updates"), (attn_lib, "mla_train"),
                (model_lib.Model, "_mtp_loss"))


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
    if "ssd_" in kernel:
        return "ssd"
    if kernel.startswith("nccl"):           # the collectives across cards
        return "nccl"
    if any("FlashAttentionBackward" in n for n in names):   # plain recompute
        return "attention backward (plain)"
    if any("_SSDBackward" in n for n in names):    # ssd_chunked recomputed
        return "ssd backward (plain)"
    if "scope:update" in names or "scope:apply_updates" in names:
        return "optimizer"
    if "scope:_mtp_loss" in names:
        return "MTP"
    if "scope:moe_apply" in names:
        return "expert GEMMs" if "aten::bmm" in names else "dispatch"
    if "scope:mla_train" in names:
        return "MLA attention (plain)"
    if "scope:_logits" in names or "scope:softmax_cross_entropy" in names:
        return "logits and loss"
    gemm = any(part in kernel.lower() for part in ("gemm", "nvjet", "xmma"))
    return "other GEMMs" if gemm else "other"


def device_ms_by_group(fn, calls: int) -> dict:
    """Device ms a call of ``fn`` by ``TRACE_GROUPS``, from a
    ``torch.profiler`` trace with ``TRACE_SCOPES`` marked: each kernel (and
    copy or memset) on the device goes to the group of the ranges around
    the op that launched it, found through the runtime call that launched
    it (the same CUDA correlation id) and the ops around that call on its
    thread.  An op the autograd engine runs for a node takes the ranges
    around the node's forward op (matched by thread and sequence number);
    code that runs inside a node in ranges of its own (a block's recompute
    under remat) keeps its own.  Kernels whose launch lies in no op are
    ``unattributed``.  Each device event counts once, so the groups sum to
    the busy time; the profiler's lists of kernels by op would count a
    launch twice where two events share an id, as its "Command Buffer Full"
    markers do with ops while the launch queue is full."""
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
    forward, launched_by = {}, {}
    for e in events:
        if id(e) not in around:
            continue
        if e.name.startswith("cu"):     # a runtime call: cudaLaunchKernel, ...
            launched_by.setdefault(e.id, e)
        elif e.sequence_nr >= 0 and \
                not e.name.startswith("autograd::engine"):
            forward.setdefault((e.thread, e.sequence_nr), e)
    ms = dict.fromkeys(TRACE_GROUPS, 0.0)
    busy = 0.0
    for k in events:
        if k.device_type != torch.autograd.DeviceType.CUDA or \
                k.is_user_annotation:
            continue
        busy += k.self_device_time_total / 1e3
        call = launched_by.get(k.id)
        chain = around[id(call)][1:] if call is not None else []
        if not chain:
            continue
        at = next((i for i, n in enumerate(chain) if n.name.startswith(
            "autograd::engine::evaluate_function")), len(chain))
        names = [n.name for n in chain[:at]]
        if at < len(chain) and not any(n.startswith("scope:") for n in names):
            node = chain[at]
            names.append(node.name)
            key = (node.fwd_thread, node.sequence_nr)
            if key in forward:
                names += [n.name for n in around[id(forward[key])]]
        ms[_trace_group(k.name, names)] += k.self_device_time_total / 1e3
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


# ---------------------------------------------------------------- phase 3a
def _last_logits(model, params, tokens, head, n: int, extra=None):
    """The train forward (``backbone``, through the flash kernel) over
    ``tokens`` ((B, T), or (B, K, T) with codebooks; ``extra``: the batch's
    other inputs, such as ``image_embeds``), and the logits of its last
    ``n`` positions only: at 32k positions all of them would be ~134 GB in
    fp32."""
    cfg = model.cfg
    B, T = tokens.shape[0], tokens.shape[-1]
    with torch.inference_mode():
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)
        h = model.backbone(params, model._embed_tokens(
            params, {"tokens": tokens, **(extra or {})}), positions)
        h = rmsnorm(params["final_ln"], h[:, -n:], cfg.norm_eps)
        return model._logits(params, h, head)[..., :cfg.vocab_size].float()


def _continue(model, params, tokens, S: int, head, extra=None):
    """``make_prefill_step`` over the first S tokens (with ``extra``, the
    batch's other inputs), the cache padded to the whole length,
    ``make_decode_step`` over the rest: -> (the prefill's last logits and
    the decode's, (n+1, B, V), or (n+1, B, K, V) with codebooks, over the
    real vocabulary, the flash launches of the prefill, the decode
    launches)."""
    V = model.cfg.vocab_size
    B, T = tokens.shape[0], tokens.shape[-1]
    _reset_counts()
    last, cache = steps_lib.make_prefill_step(model)(
        params, {"tokens": tokens[..., :S], **(extra or {})}, head=head)
    flash = _counts()
    cache = _pad_cache(model, cache, B, T)
    step = steps_lib.make_decode_step(model)
    _reset_counts()
    out = [last[..., :V].float()]
    for t in range(S, T):
        lg, cache = step(params, cache, tokens[..., t], t, head=head)
        out.append(lg[..., :V].float())
    return torch.stack(out), flash, _counts()


def _past(cfg, params, head, tokens, S: int, steps: int, extra=None):
    """A prompt of S positions through ``make_prefill_step`` (the flash
    kernel once per attention layer), its cache padded, then ``steps``
    decode steps through the decode kernel (once per layer each), against
    the train forward over all S + steps positions through the flash
    kernel, its last steps + 1 positions' logits: in ``cfg``'s dtype on
    every row of ``tokens`` (and ``extra``, the batch's other inputs),
    reported; in fp32 on the first row (``params`` cast up), held at
    ``DECODE_RTOL``.  -> ({dtype: {batch, S, rel, seconds}}, the flash and
    decode launches in ``cfg``'s dtype)."""
    L = _attention_layers(cfg)
    out, launches = {}, None
    for dtype, B in ((cfg.dtype, tokens.shape[0]), ("float32", 1)):
        weights = (params if dtype == cfg.dtype
                   else tree_map(lambda p: p.float(), params))
        model = build_model(cfg.with_(dtype=dtype))
        part = {k: v[:B] for k, v in (extra or {}).items()}
        t0 = time.perf_counter()
        got, flash, decode = _continue(model, weights, tokens[:B], S, head,
                                       part)
        _check_counts(flash, {"flash_attention": L},
                      f"{cfg.name} {dtype} prefill of {S}")
        _check_counts(decode, {"decode_attention": L * steps},
                      f"{cfg.name} {dtype} decode from the prefill cache")
        want = _last_logits(model, weights, tokens[:B], head, steps + 1, part)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name}: non-finite logits past {S}")
        out[dtype] = {"batch": B, "S": S,
                      "rel": _rel_rows(got, want.movedim(1, 0)),
                      "seconds": time.perf_counter() - t0}
        if dtype == cfg.dtype:
            launches = (flash["flash_attention"], decode["decode_attention"])
        del weights, got, want
        torch.cuda.empty_cache()
    if not out["float32"]["rel"] < DECODE_RTOL:
        raise AssertionError(f"{cfg.name} decode from the prefill cache of "
                             f"{S} vs forward: {out}")
    return out, launches


def _prefill_impls(cfg, params, batch, head) -> dict:
    """``make_prefill_step`` on ``batch`` through the kernel and through the
    plain ``torch`` and ``torch_pairs`` impls (the flash kernel once per
    layer in the first, never in the others): for each plain impl, the
    logits' largest difference from the kernel's relative to the largest
    logit, and the largest over the cache's leaves of each leaf's largest
    difference relative to its largest value."""
    outs = {}
    for impl in ("kernel", "torch", "torch_pairs"):
        _reset_counts()
        outs[impl] = steps_lib.make_prefill_step(
            build_model(cfg, attn_impl=impl))(params, batch, head=head)
        _check_counts(_counts(), {"flash_attention": _attention_layers(cfg)}
                      if impl == "kernel" else {}, f"{impl} prefill")
    V, (logits, cache) = cfg.vocab_size, outs.pop("kernel")
    out = {}
    for impl, (want_logits, want_cache) in outs.items():
        leaves = dict(named_leaves(want_cache))
        out[impl] = {
            "logits": _rel_rows(logits[:, :V], want_logits[:, :V]),
            "cache": max(((t.float() - leaves[path].float()).abs().max()
                          / leaves[path].float().abs().max()).item()
                         for path, t in named_leaves(cache))}
    return out


def prefill(card: str, srv):
    """Phase 3a: ``make_prefill_step`` on the served full-width gemma-2b (18
    layers, bf16) at ``PREFILL`` (prefill_32k's length; its batch of 32 cut
    to 4): three prefills timed, each through the flash kernel once per
    layer and through no other kernel, finite logits; the peak memory, the
    cache's size and the device ms by group.  Then 8 decode steps from the
    padded cache through the decode kernel (18 launches each) against the
    train forward over S + 8 tokens through the flash kernel, its last 9
    positions (``_past``): held at ``DECODE_RTOL`` in fp32 at batch 1 (the
    weights cast up), reported in bf16 at batch 4.
    Then, at ``PREFILL_IMPLS_S`` tokens, the logits and every cache leaf
    through the kernel against the plain ``torch`` and ``torch_pairs``
    impls (``_prefill_impls``): held at ``DECODE_RTOL`` in fp32 (the weights
    cast up), and in bf16 the logits, as ``_decode_kernel_vs_torch`` holds
    gemma-2b; bf16's caches are reported, not held: the plain impls round
    P to bf16 before P·V, the kernel does not, and a leaf of a late layer
    differed by 0.0205 of its largest value.
    Its ``[dryrun]`` runs one more prefill, with no ``head`` (the dry
    run's step casts it).
    -> (flash launches, decode launches) of the phase's main path: the
    three prefills, the ``[dryrun]`` prefill and the bf16 continuation."""
    cfg, params, head = srv.cfg, srv.params, srv.head
    B, S = PREFILL["B"], PREFILL["S"]
    L, V = _attention_layers(cfg), cfg.vocab_size
    model = build_model(cfg)
    step = steps_lib.make_prefill_step(model)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, V, (B, S + PREFILL_STEPS))).to(srv.device)
    batch = {"tokens": tokens[:, :S]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, flash_launches, logits, cache = [], 0, None, None
    for _ in range(3):
        del logits, cache
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = step(params, batch, head=head)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = _counts()
        _check_counts(counts, {"flash_attention": L}, "gemma-2b prefill")
        flash_launches += counts["flash_attention"]
    if logits.shape != (B, cfg.padded_vocab) or \
            not torch.isfinite(logits[:, :V]).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = sum(t.nbytes for _, t in named_leaves(cache)) / 1e9
    del logits, cache
    flash_launches += dryrun(
        card, f"{cfg.name} prefill", cfg, B, S, "prefill",
        lambda: step(params, batch), params, statistics.median(walls),
        hold_peak=True)["flash_attention"]
    groups = device_ms_by_group(lambda: step(params, batch, head=head),
                                calls=1)
    torch.cuda.empty_cache()

    # the continuation: bf16 at batch 4 (reported), fp32 at batch 1 (held)
    cont, (flash, decode_launches) = _past(cfg, params, head, tokens, S,
                                           PREFILL_STEPS)
    flash_launches += flash

    # the kernel against the plain impls at PREFILL_IMPLS_S tokens
    small = {"tokens": tokens[:, :PREFILL_IMPLS_S]}
    params32 = tree_map(lambda p: p.float(), params)
    impls = {"bfloat16": _prefill_impls(cfg, params, small, head),
             "float32": _prefill_impls(cfg.with_(dtype="float32"), params32,
                                       small, head)}
    del params32
    torch.cuda.empty_cache()
    if not (max(max(r.values()) for r in impls["float32"].values())
            < DECODE_RTOL and max(r["logits"] for r in
                                  impls["bfloat16"].values()) < DECODE_RTOL):
        raise AssertionError(f"prefill kernel vs plain impls: {impls}")
    _say("prefill", card=card, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, batch=B, seq_len=S,
         reduced={"batch": [32, B]}, launches_per_prefill={
             "flash_attention": L}, wall_s=walls,
         wall_s_median=statistics.median(walls),
         tokens_per_s=B * S / statistics.median(walls),
         peak_memory_gb=peak_gb, cache_gb=cache_gb,
         device_ms_by_group=groups, decode_steps=PREFILL_STEPS,
         decode_launches=decode_launches, continuation_vs_forward=cont,
         rtol=DECODE_RTOL, held="float32",
         kernel_vs_plain_impls={"S": PREFILL_IMPLS_S, **impls})
    return flash_launches, decode_launches


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


def granite(card: str) -> dict:
    """Phases 9 and 10: one granite MoE layer; granite's training from a
    lake of Zipf tokens, then the trace of one of its steps by group and
    its ``[dryrun]`` -> that step's launches."""
    moe_layer(card)
    lake = zipf_lake(GRANITE_JOB, get_arch(GRANITE).vocab_size)
    trainer, state, batch, _ = train(card, GRANITE_JOB, "train_granite", lake,
                                     TRAIN_CUT[GRANITE])
    trace_train(trainer, state, batch, card, "trace_train_granite",
                groups=True)
    return dryrun_train(card, trainer, state, batch)


# ------------------------------------------------------------- the families
FAMILY_TAGS = {STARCODER2: "starcoder2", PHI3V: "phi3v", MUSICGEN: "musicgen"}


def past_window(card: str, srv, S: int, steps: int = PAST_STEPS) -> dict:
    """``[past_window_*]``: ``_past`` on the served model, as ``[prefill]``
    holds gemma-2b: a prompt of S positions and ``steps`` decode steps,
    held in fp32 at batch 1, reported in the served dtype at batch 4.  A
    windowed model's prefill cache is its last ``window`` keys (JAX's
    ``k[:, -window:]``), in ring order here since S is a multiple of the
    window, and the decode writes ring slots ``pos % window`` over the
    oldest keys.  Image embeddings (drawn from a seeded generator) are
    spliced over the first ``num_image_tokens`` positions in the prefill
    and the forward; a model with codebooks takes (B, K, T) grids and
    gives (B, K, V) logits.  -> the served dtype's (flash, decode)
    launches, its main path."""
    cfg = srv.cfg
    L, T, K = _attention_layers(cfg), S + steps, cfg.num_codebooks
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4,) + ((K,) if K else ()) + (T,))).to(srv.device)
    extra = {}
    if cfg.num_image_tokens:
        extra["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.num_image_tokens, 1024)).astype(np.float32)).to(srv.device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, launches = _past(cfg, srv.params, srv.head, tokens, S, steps, extra)
    W = cfg.sliding_window
    _say(f"past_window_{FAMILY_TAGS[cfg.name]}", card=card, arch=cfg.name,
         layers=cfg.num_layers, reduced=_reduced(cfg), prompt=S,
         decode_steps=steps, window=W,
         ring_slots=[S % W, (T - 1) % W] if W else None,
         image_tokens=cfg.num_image_tokens, codebooks=K,
         launches={"flash_attention": L, "decode_attention": L * steps},
         continuation_vs_forward=out, rtol=DECODE_RTOL, held="float32",
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def family(card: str, arch: str) -> dict:
    """The phases of one of ``FAMILIES``: ``[train_*]`` (``train`` on
    ``FAMILY_JOBS[arch]`` from a lake of Zipf tokens, at ``TRAIN_CUT``'s
    depth if it names the arch, with no checkpoint) and its ``[dryrun]``
    step; ``[serve_*]`` (``serve``, phi-3-vision text only, as JAX serves
    it); ``[past_window_*]``.  -> the flash and decode launches of its main
    path: the training run, the ``[dryrun]`` step, the served tokens and
    the served dtype's continuation past the prompt."""
    tag, job = FAMILY_TAGS[arch], FAMILY_JOBS[arch]
    lake = zipf_lake(job, get_arch(arch).vocab_size)
    trainer, state, batch, counts = train(card, job, f"train_{tag}", lake,
                                          TRAIN_CUT.get(arch),
                                          checkpoint=False)
    flash = counts["flash_attention"]
    flash += dryrun_train(card, trainer, state, batch)["flash_attention"]
    del trainer, state, batch, lake
    torch.cuda.empty_cache()
    # one Server: the second, which gives the same tokens, is the first cut
    # that keeps the script within its clock (the earlier phases keep theirs)
    srv, decode = serve(card, arch, tag=f"serve_{tag}", second=False)
    flash += srv.launches["flash_attention"]
    past_flash, past_decode = past_window(card, srv, PAST_PROMPT[arch])
    del srv
    torch.cuda.empty_cache()
    return {"flash_attention": flash + past_flash,
            "decode_attention": decode + past_decode}


# ------------------------------------------------------------------ dryrun
# (cfg, B, S, kind) -> a future of ``dryrun_count``, made ahead by
# ``trace_ahead``
_TRACES = {}


def dryrun_count(cfg, B: int, S: int, kind: str) -> dict:
    """The dry run's count of one ``kind`` step of ``cfg`` at (B, S) with
    no mesh (``steps_lib.trace_cell``, on fake tensors on the CPU) -> its
    costs, memory, the active parameter count and the seconds it took:
    what ``dryrun`` reads, and nothing that cannot be pickled."""
    t0 = time.perf_counter()
    costs, memory, model, _ = steps_lib.trace_cell(
        cfg, ShapeConfig(f"{kind}_{B}x{S}", S, B, kind), None)
    return {"costs": costs, "memory": memory,
            "active": active_param_count(cfg, model),
            "trace_s": time.perf_counter() - t0}


def trace_ahead(cells) -> ProcessPoolExecutor:
    """``dryrun_count`` of each (cfg, B, S, kind) in ``cells``, in that
    order, in a process of its own while the card runs the phases before
    their ``[dryrun]``s (the traces are CPU work, ~44 s of the script's
    clock inline); ``dryrun`` takes each result as it needs it.  -> the
    pool, which the caller shuts down."""
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    for cell in cells:
        _TRACES[cell] = pool.submit(dryrun_count, *cell)
    return pool


def dryrun(card: str, tag: str, cfg, B: int, S: int, kind: str, run,
           state, step_s=None, hold_peak: bool = False, reps: int = 1
           ) -> dict:
    """``[dryrun]``: the dry run's count of one ``kind`` step of ``cfg`` at
    (B, S), with no mesh, against ``reps`` real steps ``run()`` on the card,
    whose state (the train state, or the parameters) is ``state``.  Gates:
    state bytes equal, kernel calls equal the launch counters' delta a
    step, and with ``hold_peak`` the peak within ``PEAK_RTOL``.  ``step_s``
    is the phase's median step; None times the ``reps`` steps here.
    -> the launch counters' delta."""
    shape = ShapeConfig(f"{kind}_{B}x{S}", S, B, kind)
    ahead = _TRACES.pop((cfg, B, S, kind), None)
    traced = ahead.result() if ahead else dryrun_count(cfg, B, S, kind)
    costs, memory = traced["costs"], traced["memory"]
    rl = Roofline(arch=cfg.name, shape=shape.name, mesh="none", chips=1,
                  flops_per_device=costs.flops,
                  bytes_per_device=costs.hbm_bytes, collective_bytes=0.0,
                  collective_breakdown={},
                  peak_memory_per_device=costs.peak_bytes,
                  model_flops_total=model_flops(cfg, shape, traced["active"]),
                  flops_by_dtype=costs.flops_by_dtype)
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in named_leaves(state))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_counts()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = _counts()
    raw_peak = torch.cuda.max_memory_allocated()
    # what the card held beside the step's arguments is not the step's
    others = before - memory["argument_bytes"]
    measured = raw_peak - others
    step_s = statistics.median(walls) if step_s is None else step_s
    calls = {k: v // reps for k, v in launches.items() if v}
    out = {
        "card": card, "arch": cfg.name, "kind": kind, "batch": B, "seq": S,
        "dtype": cfg.dtype, "remat": cfg.remat,
        "trace_s": traced["trace_s"], "traced_ahead": ahead is not None,
        "state_bytes": {"predicted": memory["state_bytes"],
                        "measured": state_bytes},
        "kernel_calls": {"predicted": costs.kernel_calls, "measured": calls,
                         "launches": launches, "steps": reps},
        "peak_bytes": {"predicted": costs.peak_bytes, "measured": measured,
                       "ratio": costs.peak_bytes / measured,
                       "max_memory_allocated": raw_peak,
                       "held_beside_arguments": others,
                       "gated": hold_peak, "rtol": PEAK_RTOL},
        "memory_analysis": memory, "flops": costs.flops,
        "flops_by_dtype": costs.flops_by_dtype, "hbm_bytes": costs.hbm_bytes,
        "model_flops": rl.model_flops_total, "step_s": step_s,
        "mfu": rl.model_flops_total / (step_s * BF16_OPS_PER_S),
        "bound_s": rl.bound_s, "dominant": rl.dominant,
        "bound_over_step": rl.bound_s / step_s,
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
    }
    _say("dryrun", step=tag, **out)
    if memory["state_bytes"] != state_bytes:
        raise AssertionError(f"[dryrun] {tag}: state bytes {out['state_bytes']}")
    if calls != costs.kernel_calls or any(v % reps for v in launches.values()):
        raise AssertionError(f"[dryrun] {tag}: kernel calls "
                             f"{out['kernel_calls']}")
    if hold_peak and not abs(costs.peak_bytes / measured - 1) <= PEAK_RTOL:
        raise AssertionError(f"[dryrun] {tag}: peak {out['peak_bytes']}")
    return launches


def dryrun_train(card: str, trainer, state, batch, hold_peak: bool = False
                 ) -> dict:
    """``[dryrun]`` of a trainer's step (it trains on), against the median
    of its run's steps 2-8."""
    job = trainer.job
    step_s = statistics.median(h["sec"] for h in trainer.history[1:])
    return dryrun(card, f"{trainer.cfg.name} train", trainer.cfg,
                  job.global_batch, job.seq_len, "train",
                  lambda: trainer.step_fn(state, batch), state, step_s,
                  hold_peak)


def dryrun_decode(card: str, srv, reps: int = 5) -> dict:
    """``[dryrun]`` of one decode step of the served model at the served
    cache (batch 4, 64 slots, the last position), through
    ``make_decode_step`` (the output projection cast per step, as the dry
    run's step does), timed over ``reps`` steps."""
    B, T = 4, 64
    model = build_model(srv.cfg)
    step = steps_lib.make_decode_step(model)
    cache = model.init_cache(B, T, srv.device)
    tokens = torch.zeros((B,), dtype=torch.int32, device=srv.device)
    launches = dryrun(card, f"{srv.cfg.name} decode", srv.cfg, B, T,
                      "decode", lambda: step(srv.params, cache, tokens,
                                             T - 1), srv.params, reps=reps)
    del cache
    return launches


# ------------------------------------------------------------ deepseek-v3
def _vm_rss_gb() -> float:
    """The process's resident memory now (``VmRSS``), in GB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no VmRSS in /proc/self/status")


def mla_decode_vs_forward(card: str, srv, steps: int = 64) -> dict:
    """tests/test_models.py's rule at full width: deepseek-v3 cut to its 3
    dense layers (no MoE layer, so no capacity question), the served
    weights; the absorbed decode logits of each of ``steps`` positions
    against the train forward's, which runs through ``mla_train``, as the
    largest difference over the vocabulary's real slots relative to the
    largest logit.  Then ``_prefill_vs_decode``'s check on the same
    tokens: the first half prefilled, its last logits against the decode's
    there, its cache padded and the second half decoded from it against the
    decode's logits.  Both held at ``DECODE_RTOL`` in fp32 (the weights cast
    up), reported in the served bf16.  No kernel is launched."""
    cfg = srv.cfg.with_(num_layers=DEEPSEEK_TRAIN_LAYERS)
    V, B = cfg.vocab_size, 2
    served = {k: v for k, v in srv.params.items()
              if k not in ("moe_blocks", "mtp")}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (B, steps))).to("cuda")
    positions = torch.arange(steps, device="cuda").expand(B, steps)
    out = {}
    _reset_counts()
    for dtype in ("float32", cfg.dtype):
        params = (served if dtype == cfg.dtype
                  else tree_map(lambda p: p.float(), served))
        model = build_model(cfg.with_(dtype=dtype))
        head = model.logits_weight(params)
        with torch.inference_mode():
            h = model._embed_tokens(params, {"tokens": tokens})
            h = model.backbone(params, h, positions)
            fwd = model._logits(params, rmsnorm(params["final_ln"], h,
                                                cfg.norm_eps), head)[..., :V]
            cache = model.init_cache(B, steps, "cuda")
            rel, decoded = [], []
            for t in range(steps):
                got, cache = model.decode_step(params, cache, tokens[:, t], t,
                                               head=head)
                got, want = got[:, :V], fwd[:, t]
                if not torch.isfinite(got).all():
                    raise AssertionError(
                        f"non-finite MLA decode logits at {t}")
                rel.append(((got - want).abs().max()
                            / want.abs().max()).item())
                decoded.append(got.float())
        P = steps // 2
        got = _continue(model, params, tokens, P, head)[0]
        prefill = {"prefill_last": _rel_rows(got[0], decoded[P - 1]),
                   "continuation": _rel_rows(got[1:],
                                             torch.stack(decoded[P:]))}
        out[dtype] = {"max": max(rel), "argmax": int(np.argmax(rel)),
                      "at": {t: rel[t] for t in (0, 1, steps // 2, steps - 1)},
                      "prefill_vs_decode": prefill}
        del params, head, h, fwd, cache, decoded
    _check_counts(_counts(), {}, "MLA decode, forward and prefill")
    if not max(out["float32"]["max"],
               *out["float32"]["prefill_vs_decode"].values()) < DECODE_RTOL:
        raise AssertionError(f"MLA decode vs forward and prefill: {out}")
    _say("mla_decode_vs_forward", card=card, arch=cfg.name,
         layers=cfg.num_layers, reduced=_reduced(cfg), batch=B, steps=steps,
         rtol=DECODE_RTOL, held="float32", **out)
    return out


def grad_deepseek(card: str, srv) -> dict:
    """One loss and gradient of the served depth-4 deepseek-v3 (3 dense
    layers, 1 MoE layer, MTP) on ``DEEPSEEK_GRAD_TOKENS`` random tokens, the
    server's fp32 head freed first: finite, with ce, aux and mtp, the
    gradient norm and the card's peak memory.  No kernel is launched."""
    cfg, params = srv.cfg, srv.params
    srv.head = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S = DEEPSEEK_GRAD_TOKENS
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to("cuda")
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    _reset_counts()
    t0 = time.perf_counter()
    loss, metrics, grads = _loss_and_grads(build_model(cfg), params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_counts(_counts(), {}, "deepseek loss and gradient")
    norm = _grad_norm(grads)
    row = {k: v.item() for k, v in metrics.items()}
    if not (math.isfinite(norm) and all(math.isfinite(v)
                                        for v in row.values())):
        raise AssertionError(f"deepseek loss or gradient not finite: {row}, "
                             f"{norm}")
    _say("grad_deepseek", card=card, arch=cfg.name, layers=cfg.num_layers,
         reduced=_reduced(cfg), d_model=cfg.d_model, dtype=cfg.dtype,
         remat=cfg.remat, batch=B, seq_len=S, **row, grad_norm=norm,
         seconds=seconds, params=count_params(build_model(cfg).param_specs()),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del grads
    return row


def deepseek(card: str):
    """Phase 2a: deepseek-v3 served, checked, differentiated and trained at
    full width with its depth cut; the process's resident memory before,
    after, and after freed heap pages go back to the system."""
    rss = {"before": _vm_rss_gb()}
    torch.cuda.empty_cache()
    srv = serve(card, DEEPSEEK, DEEPSEEK_SERVE_LAYERS, "serve_deepseek")[0]
    mla_decode_vs_forward(card, srv)
    grad_deepseek(card, srv)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    lake = zipf_lake(DEEPSEEK_JOB, get_arch(DEEPSEEK).vocab_size)
    trainer, state, batch, _ = train(card, DEEPSEEK_JOB, "train_deepseek",
                                     lake, TRAIN_CUT[DEEPSEEK])
    rss["after_train"] = _vm_rss_gb()
    trace_train(trainer, state, batch, card, "trace_train_deepseek",
                groups=True)
    del trainer, state, batch, lake
    gc.collect()
    torch.cuda.empty_cache()
    rss["after"] = _vm_rss_gb()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    rss["after_trim"] = _vm_rss_gb()
    _say("deepseek_memory", card=card, vm_rss_gb=rss,
         host_peak_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)


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
                  Hkv: int = GEMMA["Hkv"], D: int = GEMMA["D"],
                  window: int = 0):
    """The flash kernel, causal (and windowed, if ``window``), bf16; at
    gemma-2b's widths by default.  Past ``PLAIN_MAX_S`` the plain version
    timed is the ``torch`` impl's ``blockwise_attention`` (``ref_attention``'s
    scores would not fit), and fewer calls are timed (a call takes ~0.1 s at
    32k).  SDPA takes a window as a boolean mask, and then K/V expanded to
    every query head beforehand (untimed): its memory-efficient route takes
    such a mask but not ``enable_gqa``, and its math route would
    materialize the scores."""
    q, k, v = _flash_inputs(B, S, H, Hkv, D, torch.bfloat16, seed=5)
    ops, nbytes = fa_ops.costs(q, k, True, window)   # the pairs computed
    shape = (f"B={B} S={S} H={H} Hkv={Hkv} D={D} causal"
             f"{f' window={window}' if window else ''} bf16")
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))   # (B, heads, S, D)
    long = S > PLAIN_MAX_S
    mask = None
    if window:
        i = torch.arange(S, device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        k4, v4 = (t.repeat_interleave(H // Hkv, dim=1) for t in (k4, v4))

    def library():
        if mask is not None:
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    def plain():
        if long:
            return attn_lib.blockwise_attention(q, k, v, window=window,
                                                scale=1.0 / math.sqrt(D))
        return ref_attention(q, k, v, window=window)

    def kernel():
        return flash_attention(q, k, v, window=window)
    lib_err = (library().transpose(1, 2).float()
               - plain().float()).abs().max().item()
    few = dict(calls=2, replays=3) if long else {}
    return {
        "shape": shape,
        "ms": device_ms(kernel, **few),
        "call_ms": call_ms(kernel, calls=5 if long else 20),
        "plain_ms": device_ms(plain, calls=1, replays=2) if long
        else device_ms(plain, calls=5, replays=4),
        "plain": "blockwise_attention" if long else "ref_attention",
        "library_ms": device_ms(library, **few),
        "library_max_abs_err": lib_err,
        **_bound("flash_attention", shape, nbytes, ops, BF16_OPS_PER_S, card),
        "card": card,
    }


def mla_timings(card: str) -> dict:
    """Yardsticks for MLA, which runs no kernel (as in JAX): the flash
    kernel at MLA's training shape (``FLASH_MLA``) beside SDPA and the
    port's plain ``blockwise_attention``, which ``mla_train`` runs; and one
    absorbed ``mla_decode`` layer at full deepseek-v3 width on a 32k cache
    at its last position, against its byte bound: the latents and the
    layer's weights read once (and, as ``latent_bound_ms``, the latents
    alone)."""
    flash = flash_timings(**FLASH_MLA, card=card)
    q, k, v = _flash_inputs(*FLASH_MLA.values(), torch.bfloat16, seed=5)
    scale = 1.0 / math.sqrt(FLASH_MLA["D"])
    flash["blockwise_ms"] = device_ms(lambda: attn_lib.blockwise_attention(
        q, k, v, scale=scale), calls=3, replays=3)
    del q, k, v
    cfg = get_arch(DEEPSEEK)
    m, (B, T) = cfg.mla, MLA_DECODE.values()
    gen = torch.Generator("cuda").manual_seed(5)
    specs = attn_lib.mla_specs(cfg)
    params = materialize(specs, gen, "cuda")
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    ckv = torch.randn((B, T, m.kv_lora_rank), generator=gen,
                      device="cuda").to(torch.bfloat16)
    kr = torch.randn((B, T, m.rope_head_dim), generator=gen,
                     device="cuda").to(torch.bfloat16)
    latent_bytes = (ckv.numel() + kr.numel()) * 2
    weight_bytes = sum(t.numel() * t.element_size()
                       for _, t in named_leaves(params))
    nbytes = latent_bytes + weight_bytes + 2 * B * cfg.d_model * 2
    H, r, rd = cfg.num_heads, m.kv_lora_rank, m.rope_head_dim
    ops = 2 * B * (count_params(specs) + H * T * (2 * r + rd))
    shape = f"B={B} T={T} pos={T - 1} H={H} r={r} rd={rd} bf16 (one layer)"

    def call():
        return attn_lib.mla_decode(params, x, ckv, kr, T - 1, cfg)
    decode = {
        "shape": shape,
        "ms": device_ms(call, calls=10, replays=5),
        "call_ms": call_ms(call, calls=20),
        **_bound("mla_decode", shape, nbytes, ops, BF16_OPS_PER_S, card),
        "latent_bytes": latent_bytes,
        "latent_bound_ms": latent_bytes / HBM_BYTES_PER_S * 1e3,
        "weight_bytes": weight_bytes,
        "library_ms": None,
        "card": card,
    }
    del params, x, ckv, kr
    torch.cuda.empty_cache()
    out = {"flash_at_mla_training_shape": flash, "mla_decode_layer": decode}
    _say("mla_timings", **out)
    return out


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


def _dryrun_cells() -> list:
    """The (cfg, B, S, kind) of each ``[dryrun]`` of the whole script, in
    the order it runs them."""
    gemma = get_arch("gemma-2b")
    cut = {arch: _cut(get_arch(arch), TRAIN_CUT[arch])
           for arch in (MAMBA2_JOB.arch, GRANITE)}
    return [(gemma, 4, 64, "decode"),
            (gemma, PREFILL["B"], PREFILL["S"], "prefill"),
            (gemma, TRAIN_JOB.global_batch, TRAIN_JOB.seq_len, "train"),
            (cut[MAMBA2_JOB.arch], MAMBA2_JOB.global_batch, MAMBA2_JOB.seq_len,
             "train"),
            (cut[GRANITE], GRANITE_JOB.global_batch, GRANITE_JOB.seq_len,
             "train")] + [
        (get_arch(arch), FAMILY_JOBS[arch].global_batch,
         FAMILY_JOBS[arch].seq_len, "train") for arch in FAMILIES]


def main() -> None:
    card = environment()
    errors = kernel_vs_plain()
    seq_launches, seq_err, seq_timed = decode_seq_split(card)
    flash_errors = flash_vs_plain()
    flash_errors.update(flash_prefill_vs_plain())
    ssd_errors = ssd_vs_plain()
    # timed here, where the profiler's per-pass records are kept
    ssd_train, ssd_zamba2, ssd_long = (ssd_timings(shape, card) for shape in
                                       (SSD_MAMBA2, SSD_ZAMBA2, SSD_LONG))
    pre_errors = preprocess_vs_plain()
    torch.cuda.empty_cache()
    deepseek(card)      # before the phases that grow the host's memory
    feed_launches, feed_err = image_feed(card)
    torch.cuda.empty_cache()
    # traced while the card runs the phases before their [dryrun]s; started
    # after the image feed, whose loader's workers take the host's cores
    pool = trace_ahead(_dryrun_cells())
    srv, launches = serve(card, "gemma-2b")
    launches += dryrun_decode(card, srv)["decode_attention"]
    served = srv.served
    trace(srv, card)
    prefill_flash, prefill_decode = prefill(card, srv)
    launches += prefill_decode
    del srv
    torch.cuda.empty_cache()
    trainer, state, batch, counts = train(card)
    flash_launches = counts["flash_attention"] + prefill_flash
    train_ref = {"losses": [h["loss"] for h in trainer.history],
                 "step_s": statistics.median(h["sec"] for h in
                                             trainer.history[1:]),
                 "peak_gb": trainer.peak_gb}
    restored = dist_restore(trainer.ckpt, state)
    resume(card)
    trace_train(trainer, state, batch, card)
    flash_launches += dryrun_train(card, trainer, state, batch,
                                   hold_peak=True)["flash_attention"]
    del trainer, state, batch
    torch.cuda.empty_cache()
    dist_flash, dist_decode, key_split = dist(card, train_ref, served,
                                              restored)
    flash_launches += dist_flash
    launches += dist_decode
    torch.cuda.empty_cache()
    torchrun_train(card)
    lake = zipf_lake(MAMBA2_JOB, get_arch(MAMBA2_JOB.arch).vocab_size)
    trainer, state, batch, counts = train(card, MAMBA2_JOB, "train_mamba2",
                                          lake, TRAIN_CUT[MAMBA2_JOB.arch])
    ssd_launches = counts["ssd_scan"]
    trace_train(trainer, state, batch, card, "trace_train_mamba2")
    ssd_launches += dryrun_train(card, trainer, state, batch)["ssd_scan"]
    del trainer, state, batch, lake
    torch.cuda.empty_cache()
    zamba2_train = zamba2(card, ssd_zamba2)
    torch.cuda.empty_cache()
    flash_launches += granite(card)["flash_attention"]
    torch.cuda.empty_cache()
    for arch in ("mamba2-1.3b", "zamba2-2.7b", GRANITE):
        serve(card, arch)
        torch.cuda.empty_cache()
    for arch in FAMILIES:
        counts = family(card, arch)
        flash_launches += counts["flash_attention"]
        launches += counts["decode_attention"]
    decode_rows = [timings(*shape, card=card) for shape in DECODE_TIMED]
    serving = decode_rows[0]          # the served cache, T=64
    training = flash_timings(4, 1024, card)
    long_train = flash_timings(4, 4096, card)
    prefill_shape = flash_timings(**FLASH_PREFILL, card=card)
    granite_train = flash_timings(**FLASH_GRANITE, card=card)
    family_shapes = {f"{FAMILY_TAGS[arch]}_shape": flash_timings(**shape,
                                                                 card=card)
                     for arch, shape in ((STARCODER2, FLASH_STARCODER2),
                                         (PHI3V, FLASH_PHI3V),
                                         (MUSICGEN, FLASH_MUSICGEN))}
    window_shape = flash_timings(**FLASH_WINDOW, card=card)
    mla = mla_timings(card)
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
        "prefill_shape": prefill_shape,
        "zamba2_shape": zamba2_train,
        "granite_shape": granite_train,
        **family_shapes,
        "starcoder2_window_shape": window_shape,
        "mla_shape": mla,
    }
    entry = {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:65",
        "launches": launches,
        "max_abs_err": max(max(errors.values()), seq_err,
                           key_split["max_abs_err"]),
        **{k: serving[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        "shapes": decode_rows,
        "seq_split_launches": seq_launches,
        "key_split_launches": key_split["launches"],
        "seq_split_shapes": seq_timed,
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
    pool.shutdown()
    if _TRACES:
        raise AssertionError(f"traces made ahead and never read: {_TRACES}")
    _say("done", script_s=time.perf_counter() - T_START)
    print(json.dumps({"kernels": [entry, flash_entry, ssd_entry, pre_entry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
