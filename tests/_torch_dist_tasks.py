"""Worker side of ``test_torch_distributed.py``: the code each gloo rank runs.

A rank is a process started as ``python _torch_dist_tasks.py TASK RANK
WORLD STORE OUT``: it joins a gloo group through the file ``STORE``, runs
``TASK`` and writes what it found to ``OUT`` (``torch.save``), which the
test reads.  Nothing here imports jax: the JAX side of each check runs in
the test's own process or in a subprocess of its own.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch, reduce_for_smoke  # noqa: E402
from repro_torch.core.storage import LocalProvider, MemoryProvider  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    distribute, make_rules, place_tree, placements_for, sharding_for_specs,
    spec_for)
from repro_torch.launch.serve import Server, ServeJob  # noqa: E402
from repro_torch.launch.steps import (state_placements,  # noqa: E402
                                      train_state_specs)
from repro_torch.launch.train import Trainer, TrainJob  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import abstract, named_leaves  # noqa: E402

ALL_ARCHS = ("starcoder2-3b", "qwen2-72b", "gemma-2b", "gemma3-27b",
             "musicgen-medium", "phi-3-vision-4.2b", "deepseek-v3-671b",
             "granite-moe-1b-a400m", "mamba2-1.3b", "zamba2-2.7b")
# the slowest family on a model axis trains in the other 4-rank run, which
# the two runs' lengths even out
SLOWEST = ("deepseek-v3-671b",)
PLACED = ("embed", "blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wo",
          "blocks/mlp/wi", "final_ln")
GQA = dict(B=2, S=64, H=4, Hkv=2, D=32)
# decode on the GQA trap: a cache of T keys, split 4 ways by --seq-shard's
# rules on (1, 4); (impl, pos, window): pos in slice 0, a middle slice and
# the last, and a ring of T slots that has wrapped
DECODE_T = 16
DECODE_CASES = [(impl, pos, 0) for impl in ("kernel", "torch")
                for pos in (2, 9, 15)] + \
    [(impl, 21, DECODE_T) for impl in ("kernel", "torch")]
# MLA decode on a key-split latent cache: pos in the first slice of
# (1, 4)'s, in a middle one, at the last key
MLA_POSITIONS = (2, 9, 15)
# and split over two mesh dims: the long-context rules' ("pod", "data") on
# a (2, 2, 1) mesh, the batch whole, the layer's weights split over
# "fsdp" as given (so q is a pending sum)
DECODE_CASES_2D = [(impl, 9, 0) for impl in ("kernel", "torch")] + \
    [("kernel", 21, DECODE_T)]


def train_job(arch: str, steps: int, model_axis: int) -> TrainJob:
    return TrainJob(arch=arch, steps=steps, global_batch=4, seq_len=32,
                    num_docs=8, checkpoint_every=100, log_every=100,
                    model_axis=model_axis, device="cpu")


def serve_job(arch: str, model_axis: int) -> ServeJob:
    return ServeJob(arch=arch, batch=2, prompt_len=4, max_new_tokens=4,
                    model_axis=model_axis, device="cpu")


def prompts() -> np.ndarray:
    return np.random.default_rng(5).integers(0, 512, (2, 4)).astype(np.int32)


def served(arch: str, model_axis: int) -> np.ndarray:
    """A ``Server``'s greedy tokens for ``prompts()``; for a family with
    codebooks, which ``generate`` does not take, its decode logits."""
    srv = Server(serve_job(arch, model_axis))
    if not srv.cfg.num_codebooks:
        return srv.generate(prompts())
    return decode_logits(srv)


def decode_logits(srv: Server) -> np.ndarray:
    """``srv``'s decode logits over 6 steps of seeded (B,) or (B, K)
    tokens, from an empty cache."""
    K = srv.cfg.num_codebooks
    tokens = np.random.default_rng(6).integers(0, 512, (2, K, 6) if K
                                               else (2, 6))
    cache = srv.model.init_cache(2, 6, "cpu")
    if srv.mesh is not None:
        cache = srv._place(srv.model.cache_specs(2, 6), cache)
    logits = []
    with torch.no_grad():
        for t in range(6):
            out, cache = srv._step(cache, np.ascontiguousarray(tokens[..., t]),
                                   t)
            logits.append(out.numpy())
    return np.stack(logits)


def whole(tree):
    """{path: numpy array} of a state tree, gathered whole."""
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().float().numpy() for k, v in named_leaves(tree)}


def trained(res) -> dict:
    """A trainer's losses, parameters and moments, whole."""
    state = res["state"]
    return {"losses": [h["loss"] for h in res["history"]],
            "params": whole(state["params"]),
            "moments": whole({"m": state["opt"]["m"], "v": state["opt"]["v"]})}


def decode_inputs(pos: int) -> dict:
    """numpy inputs of one ``gqa_decode``: the layer's params at the GQA
    trap's heads (smoke gemma-2b's d_model and head dim), x (B, 1, d), and
    caches (B, DECODE_T, Hkv, D)."""
    rng = np.random.default_rng(20 + pos)
    c, d = GQA, gqa_config().d_model
    D = gqa_config().head_dim
    w = lambda *shape: (rng.standard_normal(shape) / np.sqrt(shape[0])
                        ).astype(np.float32)
    return {"params": {"wq": w(d, c["H"], D), "wk": w(d, c["Hkv"], D),
                       "wv": w(d, c["Hkv"], D), "wo": w(c["H"], D, d)},
            "x": rng.standard_normal((c["B"], 1, d)).astype(np.float32),
            "cache_k": rng.standard_normal(
                (c["B"], DECODE_T, c["Hkv"], D)).astype(np.float32),
            "cache_v": rng.standard_normal(
                (c["B"], DECODE_T, c["Hkv"], D)).astype(np.float32)}


def gqa_config():
    """Smoke gemma-2b with the GQA trap's heads."""
    return reduce_for_smoke(get_arch("gemma-2b")).with_(
        num_heads=GQA["H"], num_kv_heads=GQA["Hkv"])


def decode_on(mesh, rules, impl: str, pos: int, window: int) -> dict:
    """``gqa_decode`` of ``decode_inputs(pos)`` placed by ``rules`` on
    ``mesh``: the output and caches whole, the caches' placements, and the
    key rows of this rank's cache shards that the step changed (local
    index, the shard's global offset)."""
    from torch.distributed.tensor.experimental import implicit_replication

    inp = decode_inputs(pos)
    cfg = gqa_config()
    specs = attn.gqa_specs(cfg)

    def place(a, axes):
        return distribute(torch.from_numpy(a), mesh, placements_for(
            spec_for(a.shape, axes, mesh, rules), mesh))
    params = {n: place(a, specs[n].axes) for n, a in inp["params"].items()}
    x = place(inp["x"], ("batch", None, None))
    cax = ("batch", "seq", "heads", None)
    ck, cv = place(inp["cache_k"], cax), place(inp["cache_v"], cax)
    before = ck.to_local().clone()
    with torch.no_grad(), implicit_replication():
        o, ck, cv = attn.gqa_decode(params, x, ck, cv, pos, cfg,
                                    window=window, impl=impl)
    from repro_torch.distributed.sharding import _local_range
    local = ck.to_local()
    offset = _local_range(ck, 1)[0]
    changed = (local != before).flatten(2).any(-1).any(0)
    return {"out": o.full_tensor().numpy(), "cache_k": ck.full_tensor().numpy(),
            "cache_v": cv.full_tensor().numpy(),
            "placements": str(ck.placements),
            "changed": (torch.nonzero(changed).flatten().tolist(), offset)}


def mla_inputs(pos: int) -> dict:
    """numpy inputs of one ``mla_decode`` at smoke deepseek-v3's widths:
    the layer's params, x (B, 1, d) and the latent caches (B, DECODE_T, r)
    and (B, DECODE_T, rope)."""
    from repro_torch.models.attention import mla_specs
    cfg = reduce_for_smoke(get_arch("deepseek-v3-671b"))
    rng = np.random.default_rng(40 + pos)
    B, m = GQA["B"], cfg.mla
    return {"params": {n: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                           ).astype(np.float32)
                       for n, s in mla_specs(cfg).items()},
            "x": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32),
            "ckv": rng.standard_normal(
                (B, DECODE_T, m.kv_lora_rank)).astype(np.float32),
            "kr": rng.standard_normal(
                (B, DECODE_T, m.rope_head_dim)).astype(np.float32)}


def mla_decode_on(mesh, rules, pos: int,
                  x_axes=("batch", None, None)) -> dict:
    """``mla_decode`` of ``mla_inputs(pos)`` placed by ``rules`` (x by
    ``x_axes``): the output and the latent caches whole, and their
    placements."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = reduce_for_smoke(get_arch("deepseek-v3-671b"))
    inp = mla_inputs(pos)
    specs = attn.mla_specs(cfg)

    def place(a, axes):
        return distribute(torch.from_numpy(a), mesh, placements_for(
            spec_for(a.shape, axes, mesh, rules), mesh))
    params = {n: place(a, specs[n].axes) for n, a in inp["params"].items()}
    x = place(inp["x"], x_axes)
    ckv, kr = (place(inp[n], ("batch", "seq", None)) for n in ("ckv", "kr"))
    with torch.no_grad(), implicit_replication():
        o, ckv, kr = attn.mla_decode(params, x, ckv, kr, pos, cfg)
    return {"out": o.full_tensor().numpy(), "ckv": ckv.full_tensor().numpy(),
            "kr": kr.full_tensor().numpy(), "placements": str(ckv.placements)}


# one smoke mamba2 layer (16 heads of 16, one B/C group) on a model axis of
# 4 through ssd_per_shard: each rank's scan takes its 4 heads and the one
# group they all read (the kernel's G = 1)
LAYER = dict(B=2, S=64)


def layer_inputs() -> dict:
    """numpy params of one smoke mamba2 layer (its constant leaves given
    noise, so that a comparison sees them), an input u (B, S, d) and
    cotangents of the output and the final state."""
    from repro_torch.models.param import materialize
    from repro_torch.models.ssm import ssm_specs
    cfg = reduce_for_smoke(get_arch("mamba2-1.3b"))
    s, B, S = cfg.ssm, LAYER["B"], LAYER["S"]
    rng = np.random.default_rng(9)
    params = {}
    for k, t in named_leaves(materialize(ssm_specs(cfg),
                                         torch.Generator().manual_seed(9),
                                         "cpu")):
        a = t.numpy()
        if np.all(a == a.flat[0]):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        params[k] = a
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"params": params, "u": f(B, S, cfg.d_model) * 0.5,
            "gy": f(B, S, cfg.d_model),
            "gst": f(B, cfg.ssm_heads, s.d_state, s.head_dim)}


@contextlib.contextmanager
def recorded_scans():
    """The ssd wrapper, recording each call's heads and groups and, once
    the backward has run, the gradients of its x, Bm and Cm."""
    import repro_torch.kernels.ssd_scan as kernel
    real, calls = kernel.ssd, []

    def ssd(x, dt, A, Bm, Cm, **kw):
        rec = {"handed": (x.shape[2], Bm.shape[2])}
        for name, t in (("dx", x), ("dB", Bm), ("dC", Cm)):
            if t.requires_grad:
                t.register_hook(lambda g, name=name, rec=rec:
                                rec.__setitem__(name, g.detach().clone()))
        calls.append(rec)
        return real(x, dt, A, Bm, Cm, **kw)
    kernel.ssd = ssd
    try:
        yield calls
    finally:
        kernel.ssd = real


def layer_on(mesh) -> dict:
    """``mamba2_forward`` (through ``ssd_per_shard`` and the ssd wrapper)
    of ``layer_inputs()`` placed by the train rules: the output, the final
    state and the gradients of u and of every parameter, whole; the (heads,
    groups) each rank's scan was handed."""
    from repro_torch.models.ssm import mamba2_forward, ssm_specs
    cfg = reduce_for_smoke(get_arch("mamba2-1.3b"))
    inp, rules, specs = layer_inputs(), make_rules("train"), ssm_specs(cfg)

    def placed(a, axes):
        return distribute(a, mesh, placements_for(
            spec_for(tuple(a.shape), axes, mesh, rules), mesh))
    params = {k: placed(torch.from_numpy(a), specs[k].axes).requires_grad_()
              for k, a in inp["params"].items()}
    hidden = ("batch", None, None)
    u = placed(torch.from_numpy(inp["u"]), hidden).requires_grad_()
    with recorded_scans() as calls:
        y, st = mamba2_forward(params, u, cfg, return_state=True)
        y = placed(y, hidden)            # the output's pending sum reduced
        loss = (y * placed(torch.from_numpy(inp["gy"]), hidden)).sum() + (
            st * distribute(torch.from_numpy(inp["gst"]), mesh,
                            st.placements)).sum()
        loss.backward()
    return {"y": y.full_tensor().detach().numpy(),
            "state": st.full_tensor().detach().numpy(),
            "grads": {k: t.grad.full_tensor().numpy()
                      for k, t in [("u", u)] + list(params.items())},
            "handed": [c["handed"] for c in calls]}


def decode_counted(arch: str) -> dict:
    """One decode step of smoke ``arch`` served on (1, 4), as
    ``decode_logits`` takes it: the placements of the hidden state each
    layer hands the next, and the step's collectives by kind."""
    from repro_torch.launch.op_analysis import OpCounter
    srv = Server(serve_job(arch, 4))
    model, placed = srv.model, []
    cache = srv._place(model.cache_specs(2, 6), model.init_cache(2, 6, "cpu"))
    real = model._dense_step

    def step(*args, **kw):
        h = real(*args, **kw)
        placed.append(str(h.placements))
        return h
    model._dense_step = step
    counter = OpCounter()
    with torch.no_grad(), counter:
        srv._step(cache, np.zeros((2,), np.int32), 0)
    return {"placements": placed, "count": counter.costs.collective_count,
            "bytes": counter.costs.collective_by_kind}


def mamba_decode_on(arch: str, model_axis: int) -> dict:
    """Two decode steps of smoke ``arch`` served on a world of 4 with
    ``model_axis``, from an empty cache, as ``decode_logits`` takes them:
    the first step's collectives by kind, the whole step's and its mamba
    layers' (``Model._ssm_step``, each layer's fsdp gathers made before
    it), the largest collective, the caches' placements after both steps against
    their specs', and this rank's shards of the state and conv caches with
    their offsets."""
    from repro_torch.distributed.sharding import _local_box
    from repro_torch.launch.op_analysis import OpCounter
    srv = Server(serve_job(arch, model_axis))
    model = srv.model
    specs = model.cache_specs(2, 6)
    cache = srv._place(specs, model.init_cache(2, 6, "cpu"))
    counter = OpCounter()
    layer = counter.scope("mamba", model._ssm_step)
    model._ssm_step = lambda p, *args: layer(model._whole(p), *args)
    tokens = np.random.default_rng(6).integers(0, 512, (2, 6))
    with torch.no_grad():
        with counter:
            srv._step(cache, np.ascontiguousarray(tokens[:, 0]), 0)
        srv._step(cache, np.ascontiguousarray(tokens[:, 1]), 1)
    want = dict(named_leaves(sharding_for_specs(specs, srv.mesh, srv.rules)))
    out = {"mesh": tuple(srv.mesh.shape),
           "count": counter.costs.collective_count,
           "bytes": counter.costs.collective_by_kind,
           "layer": counter.costs.scoped["mamba"],
           "largest": counter.costs.largest_collective}
    for name in ("state", "conv"):
        t = cache[name]
        out[name] = {"placements": str(t.placements),
                     "spec_placements": str(want[name]),
                     "local": t.to_local().numpy().copy(),
                     "offset": tuple(_local_box(t.shape, t.device_mesh,
                                                t.placements)[1])}
    return out


MAMBA_DECODE_ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


def ssm_batch() -> dict:
    """numpy tokens, targets and loss mask of a smoke train batch (4, 64):
    two of the smoke ssm configs' 32-token chunks."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 512, (4, 65)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "loss_mask": (rng.uniform(size=(4, 64)) < 0.9).astype(np.float32)}


def ssm_grads(mesh=None) -> dict:
    """Smoke mamba2's loss and gradient of ``ssm_batch()`` (parameters from
    seed 0), under the train rules on ``mesh`` (None: one process): each
    scan's dx, dB and dC as this rank holds them, the rank's mesh
    coordinate, and the backward's collectives by kind."""
    from repro_torch.distributed.sharding import make_shard_fn
    from repro_torch.launch.op_analysis import OpCounter
    cfg = reduce_for_smoke(get_arch("mamba2-1.3b"))
    rules = make_rules("train")
    model = build_model(cfg, shard_fn=make_shard_fn(mesh, rules))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ssm_batch().items()}
    if mesh is not None:
        params = place_tree(params, sharding_for_specs(
            model.param_specs(), mesh, rules), mesh)
        batch = {k: model.shard(v, ("batch", None)) for k, v in batch.items()}
    for _, t in named_leaves(params):
        t.requires_grad_()
    counter = OpCounter()
    with recorded_scans() as calls, model.spmd():
        loss, _ = model.loss_fn(params, batch)
        with counter:
            loss.backward()
    return {"coord": mesh.get_coordinate() if mesh is not None else None,
            "scans": [{k: c[k].numpy() for k in ("dx", "dB", "dC")}
                      for c in calls],
            "count": counter.costs.collective_count,
            "bytes": counter.costs.collective_by_kind}


# GQA on (1, 4) beyond the trap: heads that all read one KV group (H=8,
# Hkv=1: each rank handed the one group head) and heads that straddle
# groups (H=12, Hkv=3: a copy for each local head), under every impl
GQA_GROUPS = {"one_group": dict(H=8, Hkv=1), "straddle": dict(H=12, Hkv=3)}
GQA_IMPLS = ("kernel", "torch", "torch_pairs")
# served and prefilled on (1, 4) and (2, 2) under the serving rules
MESH_SERVE_ARCHS = ("gemma-2b", "deepseek-v3-671b", "mamba2-1.3b",
                    "zamba2-2.7b")


def gqa_group_inputs(H: int, Hkv: int):
    g = torch.Generator().manual_seed(4)
    B, S, D = GQA["B"], GQA["S"], GQA["D"]
    return (torch.randn(B, S, H, D, generator=g),
            torch.randn(B, S, Hkv, D, generator=g),
            torch.randn(B, S, Hkv, D, generator=g))


def gqa_groups_on(mesh) -> dict:
    """``gqa_attend`` of each of ``GQA_GROUPS`` placed by the train rules on
    ``mesh``, under each impl: the output and the gradients of q, k and v
    whole, and the KV heads each call of the attention was handed."""
    handed = []

    def recording(fn):
        def call(q, k, v, **kw):
            handed.append(k.shape[2])
            return fn(q, k, v, **kw)
        return call
    real = {n: getattr(attn, n) for n in ("flash_attention",
                                          "blockwise_attention")}
    rules, ax, out = make_rules("train"), ("batch", None, "heads", None), {}
    try:
        for n, fn in real.items():
            setattr(attn, n, recording(fn))
        for name, heads in GQA_GROUPS.items():
            cfg = gqa_config().with_(num_heads=heads["H"],
                                     num_kv_heads=heads["Hkv"])
            for impl in GQA_IMPLS:
                handed.clear()
                q, k, v = (distribute(t, mesh, placements_for(spec_for(
                    tuple(t.shape), ax, mesh, rules), mesh)).requires_grad_()
                    for t in gqa_group_inputs(**heads))
                o = attn.gqa_attend(q, k, v, cfg, impl=impl)
                (o * o).sum().backward()
                out[name, impl] = {
                    "out": o.full_tensor().detach().numpy(),
                    **{f"d{n}": t.grad.full_tensor().numpy()
                       for n, t in (("q", q), ("k", k), ("v", v))},
                    "handed": list(handed),
                    "kv_placements": str(k.placements)}
    finally:
        for n, fn in real.items():
            setattr(attn, n, fn)
    return out


def prefill_tokens() -> np.ndarray:
    return np.random.default_rng(7).integers(0, 512, (4, 8))


def prefilled(arch: str, mesh=None) -> dict:
    """Smoke ``arch``'s ``Model.prefill`` of ``prefill_tokens()`` under the
    prefill rules on ``mesh`` (None: one process), as a meshed ``Server``
    runs a step: the last token's logits and the cache, whole."""
    from repro_torch.distributed.sharding import make_shard_fn
    cfg = reduce_for_smoke(get_arch(arch))
    rules = make_rules("prefill")
    model = build_model(cfg, shard_fn=make_shard_fn(mesh, rules))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(prefill_tokens())
    if mesh is not None:
        params = place_tree(params, sharding_for_specs(
            model.param_specs(), mesh, rules), mesh)
        tokens = model.shard(tokens, ("batch", None))
    with torch.no_grad(), model.spmd():
        logits, cache = model.prefill(params, {"tokens": tokens})
    full = lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t
                      ).float().numpy()
    return {"logits": full(logits),
            "cache": {k: full(v) for k, v in named_leaves(cache)}}


def gqa_inputs():
    g = torch.Generator().manual_seed(3)
    c = GQA
    q = torch.randn(c["B"], c["S"], c["H"], c["D"], generator=g)
    k = torch.randn(c["B"], c["S"], c["Hkv"], c["D"], generator=g)
    v = torch.randn(c["B"], c["S"], c["Hkv"], c["D"], generator=g)
    return q, k, v


# ------------------------------------------------------------------ tasks
def task_allreduce(rank, out, store_dir):
    """(2, 4) as (pod, data) over 8 ranks: the int8 mean over pods."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.collectives import (collective_wire_bytes,
                                                     make_quantized_allreduce)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 16))
                         .astype(np.float32))
    got = make_quantized_allreduce(mesh, "pod")({"g": x})["g"]
    out["allreduce"] = got.numpy()
    out["wire"] = (collective_wire_bytes({"g": x}, True),
                   collective_wire_bytes({"g": x}, False))


def task_world4(rank, out, store_dir):
    """Placements, the GQA trap and data-parallel training on 4."""
    from torch.distributed.device_mesh import init_device_mesh
    # placements: each rank's shard of a few params on two meshes
    cfg = reduce_for_smoke(get_arch("gemma-2b"))
    specs = build_model(cfg).param_specs()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    shards = {}
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 1), ("pod", "data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        placed = place_tree(params, sharding_for_specs(
            specs, mesh, make_rules("train")), mesh)
        flat = dict(named_leaves(placed))
        shards[names] = {p: flat[p].to_local().numpy() for p in PLACED}
    out["shards"] = shards

    # the GQA trap: H=4, Hkv=2 on a (1, 4) mesh, KV heads left whole
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    rules = make_rules("train")
    q, k, v = gqa_inputs()
    ax = ("batch", None, "heads", None)
    dq, dk, dv = (distribute(t, mesh, placements_for(
        spec_for(tuple(t.shape), ax, mesh, rules), mesh)) for t in (q, k, v))
    cfg_g = cfg.with_(num_heads=GQA["H"], num_kv_heads=GQA["Hkv"])
    dq.requires_grad_()
    dk.requires_grad_()
    o = attn.gqa_attend(dq, dk, dv, cfg_g, impl="kernel")
    (o * o).sum().backward()
    out["gqa"] = {"kv_placements": str(dk.placements),
                  "out": o.full_tensor().detach().numpy(),
                  "dq": dq.grad.full_tensor().numpy(),
                  "dk": dk.grad.full_tensor().numpy()}
    # the plain impls on the same trap, forward and gradients
    out["gqa_plain"] = {}
    for impl in ("torch", "torch_pairs"):
        a, b, c = (t.detach().requires_grad_() for t in (dq, dk, dv))
        o = attn.gqa_attend(a, b, c, cfg_g, impl=impl)
        (o * o).sum().backward()
        out["gqa_plain"][impl] = {
            "out": o.full_tensor().detach().numpy(),
            **{f"d{n}": t.grad.full_tensor().numpy()
               for n, t in (("q", a), ("k", b), ("v", c))}}
    # decode on the trap: the KV heads whole (the decode rules), and the
    # cache split over its keys (--seq-shard's rules)
    out["decode"] = {(impl, 9, 0, "heads"): decode_on(
        mesh, make_rules("decode"), impl, 9, 0) for impl in ("kernel", "torch")}
    seq = make_rules("decode", seq_shard="model")
    for impl, pos, window in DECODE_CASES:
        out["decode"][impl, pos, window, "keys"] = decode_on(
            mesh, seq, impl, pos, window)
    out["mla_decode"] = mla_decode_on(mesh, seq, 9)
    # MLA's latent caches split over their keys on (1, 4) and (2, 2)
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out["mla_key_split"] = {(shape, pos): mla_decode_on(m, seq, pos)
                            for shape, m in (((1, 4), mesh), ((2, 2), mesh22))
                            for pos in MLA_POSITIONS}
    # the decode rules on (2, 2), x's d split over "model" as a decode
    # step hands it to the layer: the rope query a pending sum
    out["mla_decode_rules"] = {pos: mla_decode_on(
        mesh22, make_rules("decode"), pos, ("batch", None, "model"))
        for pos in MLA_POSITIONS}
    out["ssd_per_shard"] = layer_on(mesh)
    out["ssm_grads"] = ssm_grads(mesh22)
    out["decode_counted"] = {a: decode_counted(a)
                             for a in ("gemma-2b", "deepseek-v3-671b")}
    # a mamba layer's decode step on each rank's heads, (1, 4) and (2, 2)
    out["mamba_decode"] = {(a, model_axis): mamba_decode_on(a, model_axis)
                           for a in MAMBA_DECODE_ARCHS
                           for model_axis in (4, 2)}
    out["gqa_groups"] = gqa_groups_on(mesh)
    # the serving rules on (1, 4) and (2, 2): each rank looks its tokens
    # up in its own vocab shard
    out["decode_1x4"] = {a: decode_logits(Server(serve_job(a, 4)))
                         for a in MESH_SERVE_ARCHS}
    out["serve_1x4"] = {a: served(a, 4) for a in MESH_SERVE_ARCHS}
    out["prefill"] = {(shape, a): prefilled(a, m) for a in MESH_SERVE_ARCHS
                      for shape, m in (((1, 4), mesh), ((2, 2), mesh22))}
    mesh3 = init_device_mesh("cpu", (2, 2, 1),
                             mesh_dim_names=("pod", "data", "model"))
    long = make_rules("decode", long_context=True)
    for impl, pos, window in DECODE_CASES_2D:
        out["decode"][impl, pos, window, "keys_2d"] = decode_on(
            mesh3, long, impl, pos, window)

    # every family at data 4 / model 1 for one step
    out["data4"] = {arch: trained(Trainer(train_job(arch, 1, 1))
                                  .run(restore=False)) for arch in ALL_ARCHS}
    out["model2"] = train_model2(SLOWEST)[0]


def train_model2(archs):
    """-> ({arch: trained}, the trainer and state of gemma-2b, if among
    ``archs``), each family run 3 steps on (2, 2) with model_axis=2."""
    train, gemma = {}, None
    for arch in archs:
        t = Trainer(train_job(arch, 3, 2))
        res = t.run(restore=False)
        train[arch] = dict(trained(res), mesh=tuple(t.mesh.shape))
        if arch == "gemma-2b":
            gemma = t, res["state"]
    return train, gemma


def task_model2(rank, out, store_dir):
    """Every family but ``SLOWEST`` on (2, 2) with model_axis=2: 3 training
    steps; every family served there; then elastic restore of gemma's
    state."""
    from torch.distributed.device_mesh import DeviceMesh
    out["model2"], (gemma, state) = train_model2(
        a for a in ALL_ARCHS if a not in SLOWEST)
    out["serve"] = {arch: served(arch, 2) for arch in ALL_ARCHS}

    # elastic restore: gemma's (2, 2) state saved by rank 0, restored onto
    # ranks 0 and 1 as (2, 1), and onto none
    ckpt_dir = str(Path(store_dir) / "ckpt")
    mgr = CheckpointManager(LocalProvider(ckpt_dir) if rank == 0
                            else MemoryProvider(), async_save=False)
    mgr.save(state, step=3)
    out["saved"] = whole(state)
    sub = DeviceMesh("cpu", [[0], [1]], mesh_dim_names=("data", "model"))
    if rank < 2:
        rmgr = CheckpointManager(LocalProvider(ckpt_dir) if rank == 0
                                 else MemoryProvider())
        t = gemma
        like = abstract(train_state_specs(t.model, t.opt))
        restored = rmgr.restore(like, 3, shardings=state_placements(
            t.model, t.opt, sub, t.rules), mesh=sub)
        out["restored2"] = whole(restored)
        out["restored2_local"] = {k: v.to_local().shape for k, v in
                                  named_leaves(restored)}
        if rank == 0:
            out["restored0"] = whole(rmgr.restore(like, 3))
    dist.barrier()


def task_serve2(rank, out, store_dir):
    """A model-axis-2 Server on a world of 2."""
    srv = Server(serve_job("granite-moe-1b-a400m", 2))
    out["mesh"] = tuple(srv.mesh.shape)
    out["serve"] = srv.generate(prompts())


# ------------------------------------------------- each rank's share
SHARE_MESHES = {"ce": ((2, 2), (4, 1), (1, 4)), "moe": ((2, 2), (4, 1))}
# deepseek-v3's MoE options on granite's smoke config, as test_torch_moe.py
MOE_VARIANTS = {"granite": {},
                "sigmoid_shared": dict(router="sigmoid", num_shared=1)}


def ce_cases() -> dict:
    """name -> (logits, targets, mask or None, the logits' logical axes):
    fp32 logits over a vocabulary of 64, masked and unmasked, and a
    codebook axis as musicgen's."""
    rng = np.random.default_rng(11)
    V = 64
    logits = (3 * rng.standard_normal((4, 6, V))).astype(np.float32)
    targets = rng.integers(0, V, (4, 6)).astype(np.int64)
    mask = (rng.uniform(size=(4, 6)) < 0.7).astype(np.float32)
    logits4 = (3 * rng.standard_normal((4, 6, 2, V))).astype(np.float32)
    targets4 = rng.integers(0, V, (4, 6, 2)).astype(np.int64)
    mask4 = np.ascontiguousarray(np.broadcast_to(mask[..., None], (4, 6, 2)))
    return {"masked": (logits, targets, mask, ("batch", None, "vocab")),
            "mean": (logits, targets, None, ("batch", None, "vocab")),
            "codebooks": (logits4, targets4, mask4,
                          ("batch", None, None, "vocab"))}


def moe_config(variant: str):
    """granite's smoke MoE at capacity factor 1.0: 8 experts, top 2."""
    import dataclasses
    cfg = reduce_for_smoke(get_arch("granite-moe-1b-a400m"))
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0, **MOE_VARIANTS[variant]))


def moe_inputs(cfg) -> tuple:
    """(numpy params of one MoE layer, x (4, 16, d), the output's cotangent
    g): a router biased towards experts 0 and 1 (x's first feature is 2 on
    every token), so that their queues overflow the capacity."""
    from repro_torch.models.moe import moe_specs
    rng = np.random.default_rng(12)
    params = {}
    for path, s in named_leaves(moe_specs(cfg)):
        params[path] = (rng.standard_normal(s.shape)
                        / np.sqrt(s.shape[-2])).astype(np.float32)
    params["router"][0, :2] += 1.5
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    x[..., 0] = 2.0
    g = rng.standard_normal(x.shape).astype(np.float32)
    return params, x, g


def task_share(rank, out, store_dir):
    """The vocab-parallel loss (value and gradient) and ``moe_apply`` on
    expert shards (output, aux loss, gradients), on each of
    ``SHARE_MESHES``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import make_shard_fn
    from repro_torch.models.layers import softmax_cross_entropy
    from repro_torch.models.moe import moe_apply, moe_specs
    full = lambda t: t.full_tensor().detach().numpy()
    meshes = {shape: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "model"))
              for shape in set(SHARE_MESHES["ce"] + SHARE_MESHES["moe"])}
    for shape in SHARE_MESHES["ce"]:
        shard = make_shard_fn(meshes[shape], make_rules("train"))
        for name, (logits, targets, mask, axes) in ce_cases().items():
            lt = shard(torch.from_numpy(logits), axes).requires_grad_()
            tt = shard(torch.from_numpy(targets), axes[:-1])
            mt = None if mask is None else \
                shard(torch.from_numpy(mask), axes[:-1])
            with implicit_replication():
                loss = softmax_cross_entropy(lt, tt, mt)
            loss.backward()
            out["ce", shape, name] = {
                "loss": full(loss), "grad": full(lt.grad),
                "local": tuple(lt.to_local().shape)}
    for variant in MOE_VARIANTS:
        cfg = moe_config(variant)
        params, x, g = moe_inputs(cfg)
        for shape in SHARE_MESHES["moe"]:
            mesh = meshes[shape]
            # a layer's weights as it computes with them: split over the
            # model axis, whole over the fsdp axes (``Model._whole``)
            rules = make_rules("train", fsdp=False)
            pl = dict(named_leaves(sharding_for_specs(moe_specs(cfg), mesh,
                                                      rules)))
            tp = {k: distribute(torch.from_numpy(v), mesh, pl[k])
                  .requires_grad_() for k, v in params.items()}
            shard = make_shard_fn(mesh, rules)
            tx = shard(torch.from_numpy(x), ("batch", None, None)
                       ).requires_grad_()
            with implicit_replication():
                y, aux = moe_apply(tp, tx, cfg, shard=shard)
                loss = torch.sum(y * shard(torch.from_numpy(g),
                                           ("batch", None, None))) + 3 * aux
            loss.backward()
            out["moe", shape, variant] = {
                "out": full(y), "aux": full(aux), "dx": full(tx.grad),
                "grads": {k: full(t.grad) for k, t in tp.items()},
                "wi_local": tuple(tp["wi"].to_local().shape)}


TASKS = {"allreduce": task_allreduce, "world4": task_world4,
         "model2": task_model2, "serve2": task_serve2, "share": task_share}


def main() -> None:
    task, rank, world, store, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    out: dict = {}
    try:
        TASKS[task](rank, out, str(Path(store).parent))
    finally:
        torch.save(out, out_path)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
