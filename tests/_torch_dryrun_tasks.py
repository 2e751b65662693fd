"""Worker side of ``test_torch_dryrun_mesh.py``: each task runs in a process
of its own, as rank 0 of a fake process group (one group a process), and
writes what it found to a JSON file.

    python _torch_dryrun_tasks.py TASK OUT

Nothing here imports jax; the JAX side of each check runs in the test.
The dry run's modules are imported inside the tasks that use them:
``deepseek`` and ``prefill_mesh`` use only what the port had before it.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import (ARCHS, SHAPES, cell_is_runnable,  # noqa: E402
                                 get_arch, reduce_for_smoke)
from repro_torch.configs.base import ShapeConfig  # noqa: E402

SMOKE_TRAIN = ShapeConfig("smoke_train", 32, 4, "train")


def fake_mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def nbytes(tree) -> int:
    from repro_torch.launch.steps import _local_leaves
    return sum(t.numel() * t.element_size() for t in _local_leaves(tree))


def task_bytes(multi: bool, shape=None) -> dict:
    """One device's bytes of params, optimizer state, decode cache and
    inputs, for every runnable (arch, shape) on the production slice, or on
    a (data, model) mesh of ``shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.steps import build_cell
    mesh = make_fake_mesh(multi_pod=multi, shape=shape)
    out = {}
    for arch in sorted(ARCHS):
        for shape, sc in SHAPES.items():
            if not cell_is_runnable(arch, shape):
                continue
            with FakeTensorMode():
                _, _, args, _ = build_cell(ARCHS[arch], sc, mesh)
                if sc.kind == "train":
                    got = {"params": nbytes(args[0]["params"]),
                           "opt": nbytes(args[0]["opt"]),
                           "inputs": nbytes(args[1])}
                elif sc.kind == "prefill":
                    got = {"params": nbytes(args[0]),
                           "inputs": nbytes(args[1])}
                else:
                    got = {"params": nbytes(args[0]),
                           "cache": nbytes(args[1]),
                           "inputs": nbytes(args[2])}
            out[f"{arch}/{shape}"] = got
    return out


def task_abstract() -> dict:
    """``abstract_state``'s local shards against ``init_state`` +
    ``place_tree``'s, smoke gemma-2b and deepseek-v3 on a (2, 2) mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import make_rules, make_shard_fn
    from repro_torch.launch.steps import (abstract_state, init_state,
                                          train_state_specs)
    from repro_torch.models.model import build_model
    from repro_torch.models.param import named_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    mesh = fake_mesh((2, 2))
    out = {}
    for arch in ("gemma-2b", "deepseek-v3-671b", "zamba2-2.7b"):
        cfg = reduce_for_smoke(get_arch(arch))
        rules = make_rules("train")
        model = build_model(cfg, shard_fn=make_shard_fn(mesh, rules))
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
        real = init_state(model, opt, torch.Generator().manual_seed(0), "cpu",
                          mesh=mesh, rules=rules)
        with FakeTensorMode():
            fake = abstract_state(train_state_specs(model, opt), mesh, rules)
        desc = lambda t: [list(t.to_local().shape), str(t.dtype),
                          [str(p) for p in t.placements], list(t.shape)]
        out[arch] = {"real": {k: desc(t) for k, t in named_leaves(real)},
                     "fake": {k: desc(t) for k, t in named_leaves(fake)}}
    return out


def _parent_leaf(shape, dtype, mesh, placements, make=torch.empty):
    """A DTensor made from this rank's shard by ``make``, with the calls
    the port had before the dry run (``DTensor.from_local``)."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            local[p.dim] //= size
    return DTensor.from_local(make(local, dtype=dtype), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _placed(specs, placements, mesh, make=torch.empty):
    from repro_torch.models.param import named_leaves, torch_dtype, unflatten
    pl = dict(named_leaves(placements))
    return unflatten((k, _parent_leaf(s.shape, torch_dtype(s.dtype), mesh,
                                      pl[k], make))
                     for k, s in named_leaves(specs))


def task_deepseek() -> dict:
    """A smoke deepseek-v3 train step on fake tensors, (2, 2), through the
    port's step as it stood before the dry run: the state, each rank's
    shards; the batch split by the rules."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (batch_specs, make_rules,
                                                  make_shard_fn,
                                                  sharding_for_specs)
    from repro_torch.launch.steps import make_train_step, train_state_specs
    from repro_torch.models.model import build_model
    from repro_torch.models.param import named_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    mesh = fake_mesh((2, 2))
    cfg = reduce_for_smoke(get_arch("deepseek-v3-671b"))
    rules = make_rules("train")
    model = build_model(cfg, shard_fn=make_shard_fn(mesh, rules))
    opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
    specs = train_state_specs(model, opt)
    metas, bpl = batch_specs(cfg, SMOKE_TRAIN, mesh, rules)
    with FakeTensorMode():
        state = _placed(specs, sharding_for_specs(specs, mesh, rules), mesh)
        batch = {k: _parent_leaf(tuple(m.shape), m.dtype, mesh, bpl[k])
                 for k, m in metas.items()}
        _, metrics = make_train_step(model, opt)(state, batch)
    return {"metrics": sorted(metrics),
            "state": {k: list(t.to_local().shape)
                      for k, t in named_leaves(state)}}


def _counted(cfg, shape, mesh, fake: bool) -> dict:
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.steps import _local_leaves, build_cell, trace_cell
    if fake:
        costs = trace_cell(cfg, shape, mesh, attn_impl="torch")[0]
    else:
        _, fn, args, _ = build_cell(cfg, shape, mesh, attn_impl="torch")
        gen = torch.Generator().manual_seed(0)
        for t in _local_leaves(args):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
            else:
                t.zero_()
        counter = OpCounter()
        counter.hold(_local_leaves(args))
        with counter:
            fn(*args)
        costs = counter.costs
    return {"flops": costs.flops, "collective_count": costs.collective_count,
            "collective_bytes": costs.collective_bytes,
            "peak_bytes": costs.peak_bytes, "hbm_bytes": costs.hbm_bytes}


def task_fake_vs_real() -> dict:
    """The counter over one smoke train step on fake and on real tensors,
    with no mesh and on a fake (2, 2) group; and smoke phi-3-vision's on
    the group, whose attention's batch and head splits DTensor merged into
    one dim it could place only by reading values."""
    cfg = reduce_for_smoke(get_arch("gemma-2b"))
    out = {"none": {kind: _counted(cfg, SMOKE_TRAIN, None, kind == "fake")
                    for kind in ("fake", "real")}}
    mesh = fake_mesh((2, 2))
    out["mesh"] = {kind: _counted(cfg, SMOKE_TRAIN, mesh, kind == "fake")
                   for kind in ("fake", "real")}
    phi = reduce_for_smoke(get_arch("phi-3-vision-4.2b"))
    out["phi3_mesh"] = {kind: _counted(phi, SMOKE_TRAIN, mesh, kind == "fake")
                        for kind in ("fake", "real")}
    return out


# decode on a key-split cache: smoke qwen2-72b with two KV heads, which
# the decode rules split over "model" and --seq-shard's leave whole
SEQ_SHAPE = ShapeConfig("seq", 64, 4, "decode")
SEQ_KV_HEADS = 2


def task_seq_shard() -> dict:
    """A smoke decode step on the fake (2, 2) group under the decode rules
    and under --seq-shard's (the cache's keys split over "model"): the
    collectives each sends and the per-device peak."""
    from repro_torch.launch.steps import trace_cell
    mesh = fake_mesh((2, 2))
    cfg = reduce_for_smoke(get_arch("qwen2-72b")).with_(
        num_kv_heads=SEQ_KV_HEADS)
    out = {}
    for name, seq in (("default", False), ("seq_shard", True)):
        costs, memory, _, rules = trace_cell(
            cfg.with_(seq_shard_attn=seq), SEQ_SHAPE, mesh)
        out[name] = {"collective_by_kind": costs.collective_by_kind,
                     "kernel_calls": costs.kernel_calls,
                     "peak_bytes": memory["peak_bytes"],
                     "seq_rule": rules["seq"]}
    out["cfg"] = [cfg.num_layers, cfg.num_heads, cfg.head_dim,
                  SEQ_SHAPE.global_batch]
    return out


# decode on a key-split cache, GQA and MLA: smoke qwen2-72b (two KV heads)
# and smoke deepseek-v3, each at two cache lengths, on a fake group of
# (2, 2) or (1, 4)
KEY_SPLIT_ARCHS = ("qwen2-72b", "deepseek-v3-671b")
KEY_SPLIT_T = (64, 128)


def lookup_counts(costs) -> dict:
    """The collectives of a traced step's embedding lookups, by kind and
    count."""
    return costs.scoped.get("lookup", {"by_kind": {}, "count": {}})


def task_key_split(shape) -> dict:
    """Each arch's smoke decode step under the decode rules and under
    --seq-shard's, at each of ``KEY_SPLIT_T``: the collectives it sends and
    the largest one; the widths that say what the token's operands are;
    and its embedding lookups', in decode and in a train step."""
    from repro_torch.launch.steps import trace_cell
    mesh = fake_mesh(shape)
    out = {}
    for arch in KEY_SPLIT_ARCHS:
        cfg = reduce_for_smoke(get_arch(arch))
        if cfg.mla is None:
            cfg = cfg.with_(num_kv_heads=SEQ_KV_HEADS)
        widths = [cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                  cfg.head_dim]
        if cfg.mla is not None:
            widths += [cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim]
        out[arch] = {"widths": widths,
                     "table": [cfg.padded_vocab, cfg.d_model, 4],
                     "lookup_train": lookup_counts(
                         trace_cell(cfg, SMOKE_TRAIN, mesh)[0])}
        for T in KEY_SPLIT_T:
            sc = ShapeConfig("seq", T, SEQ_SHAPE.global_batch, "decode")
            for name, seq in (("default", False), ("seq_shard", True)):
                costs = trace_cell(cfg.with_(seq_shard_attn=seq), sc,
                                   mesh)[0]
                out[arch][f"{name}_{T}"] = costs.collective_by_kind
                out[arch][f"{name}_{T}_largest"] = costs.largest_collective
                if not seq:
                    out[arch][f"lookup_{T}"] = lookup_counts(costs)
    return out


def task_allreduce() -> dict:
    """A matmul whose contraction dim is split over 8 ranks: the counter
    sees the all-reduce its result needs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import sharded
    from repro_torch.launch.op_analysis import OpCounter
    mesh = fake_mesh((8,), ("d",))
    with FakeTensorMode():
        x = sharded(torch.empty, (1024, 256), torch.float32, mesh,
                    [Shard(1)])
        w = sharded(torch.empty, (256, 256), torch.float32, mesh,
                    [Shard(0)])
        counter = OpCounter()
        with counter:
            (x @ w).redistribute(mesh, [Replicate()])
        # a shard-to-shard redistribution on this "cpu" mesh
        moved = OpCounter()
        with moved:
            y = x.redistribute(mesh, [Shard(0)])
    return {**counter.costs.to_json(), "alltoall": {
        **moved.costs.to_json(), "local": list(y.to_local().shape)}}


def task_prefill_mesh() -> dict:
    """A smoke prefill on real tensors over a fake (2, 2) group, through
    ``Model.prefill`` as a meshed ``Server`` runs a step: its cache is
    placed as the rules say."""
    from repro_torch.distributed.sharding import (batch_specs, make_rules,
                                                  make_shard_fn,
                                                  sharding_for_specs)
    from repro_torch.models.model import build_model
    from repro_torch.models.param import named_leaves
    mesh = fake_mesh((2, 2))
    out = {}
    for arch in ("gemma-2b", "mamba2-1.3b"):
        cfg = reduce_for_smoke(get_arch(arch))
        rules = make_rules("prefill")
        model = build_model(cfg, shard_fn=make_shard_fn(mesh, rules))
        specs = model.param_specs()
        params = _placed(specs, sharding_for_specs(specs, mesh, rules), mesh,
                         torch.zeros)
        metas, bpl = batch_specs(cfg, ShapeConfig("p", 32, 4, "prefill"),
                                 mesh, rules)
        batch = {k: _parent_leaf(tuple(m.shape), m.dtype, mesh, bpl[k],
                                 torch.zeros) for k, m in metas.items()}
        with torch.no_grad(), model.spmd():
            logits, cache = model.prefill(params, batch)
        out[arch] = {"logits": list(logits.shape), "cache": {
            k: [list(t.shape), [str(p) for p in t.placements]]
            for k, t in named_leaves(cache)}}
    return out


# the shares of the production mesh: sizes at which a whole-batch tensor
# would outweigh every rank's shards
SHARE_GEMMA = dict(vocab_size=4096)
SHARE_GEMMA_SHAPE = ShapeConfig("share", 64, 256, "train")
SHARE_GRANITE_SHAPE = ShapeConfig("share", 32, 256, "train")
SHARE_CACHE = (32, 256)


def task_mesh_share() -> dict:
    """On the (16, 16) fake group: a smoke gemma-2b train step whose global
    logits would be the largest tensor; a smoke granite step (16 experts,
    one a model rank) whose global token table would be; ``init_cache``
    counted on its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import make_rules, make_shard_fn
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.steps import _local_leaves, trace_cell
    from repro_torch.models.model import build_model
    from repro_torch.models.param import named_leaves
    mesh = make_fake_mesh()
    gemma = reduce_for_smoke(get_arch("gemma-2b")).with_(**SHARE_GEMMA)
    traced = lambda cfg, shape: [
        trace_cell(cfg, shape, mesh)[1][k]
        for k in ("peak_bytes", "largest_bytes")]
    costs, memory, _, _ = trace_cell(gemma, SHARE_GEMMA_SHAPE, mesh)
    out = {"gemma": [memory["peak_bytes"], memory["largest_bytes"]]}
    granite = reduce_for_smoke(get_arch("granite-moe-1b-a400m"))
    granite = granite.with_(moe=dataclasses.replace(granite.moe,
                                                    num_experts=16))
    out["granite"] = traced(granite, SHARE_GRANITE_SHAPE)
    out["granite_moe"] = [granite.moe.num_experts, granite.moe.top_k,
                          granite.d_model]
    out["lookup"] = {"train": lookup_counts(costs), "decode": lookup_counts(
        trace_cell(gemma, ShapeConfig("share", 64, 256, "decode"),
                   mesh)[0])}
    out["lookup_widths"] = [gemma.padded_vocab, gemma.d_model]
    rules = make_rules("prefill")
    with FakeTensorMode():
        model = build_model(gemma, shard_fn=make_shard_fn(mesh, rules))
        counter = OpCounter()
        with counter:
            cache = model.init_cache(*SHARE_CACHE, "cpu")
        size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        out["cache"] = {"peak": counter.costs.peak_bytes,
                        "shards": size(_local_leaves(cache)),
                        "global": size(t for _, t in named_leaves(cache))}
    return out


TASKS = {"bytes_single": lambda: task_bytes(False),
         "bytes_multi": lambda: task_bytes(True),
         "bytes_2x2": lambda: task_bytes(False, (2, 2)),
         "abstract": task_abstract, "deepseek": task_deepseek,
         "fake_vs_real": task_fake_vs_real, "allreduce": task_allreduce,
         "seq_shard": task_seq_shard,
         "key_split_2x2": lambda: task_key_split((2, 2)),
         "key_split_1x4": lambda: task_key_split((1, 4)),
         "prefill_mesh": task_prefill_mesh, "mesh_share": task_mesh_share}


if __name__ == "__main__":
    task, out = sys.argv[1], Path(sys.argv[2])
    out.write_text(json.dumps(TASKS[task]()))
