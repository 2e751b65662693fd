"""Worker side of ``test_torch_distributed.py``: the code each gloo rank runs.

A rank is a process started as ``python _torch_dist_tasks.py TASK RANK
WORLD STORE OUT``: it joins a gloo group through the file ``STORE``, runs
``TASK`` and writes what it found to ``OUT`` (``torch.save``), which the
test reads.  Nothing here imports jax: the JAX side of each check runs in
the test's own process or in a subprocess of its own.
"""

from __future__ import annotations

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
    codebooks, which ``generate`` does not take, its decode logits over 6
    steps of seeded (B, K) tokens."""
    srv = Server(serve_job(arch, model_axis))
    K = srv.cfg.num_codebooks
    if not K:
        return srv.generate(prompts())
    tokens = np.random.default_rng(6).integers(0, 512, (2, K, 6))
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


TASKS = {"allreduce": task_allreduce, "world4": task_world4,
         "model2": task_model2, "serve2": task_serve2}


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
