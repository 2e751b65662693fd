"""The distribution slice against JAX, on gloo ranks on the CPU (no card, no
network): the logical-axis rules, the placements they give, the int8
all-reduce, the trainer and server on a mesh, and the elastic restore.

The JAX trainer does not run on this jax (its mesh path fails in
``make_shard_fn``), so a trainer on a mesh is held against the port's own
single-process trainer, which the other tests hold against JAX.  The ranks
are processes running ``_torch_dist_tasks.py``; they meet through a file
under ``tmp_path`` and each spawn has a time limit, so a hung rank fails its
test rather than the run.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShape
from repro.distributed import sharding as jsh
from repro.distributed.collectives import collective_wire_bytes as jax_wire
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCHS, ShapeConfig, get_arch
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import MeshDesc, make_production_mesh
from repro_torch.launch.train import Trainer
from repro_torch.models import attention as attn
from repro_torch.models.model import build_model
from repro_torch.models.param import (DEFAULT_RULES, logical_to_spec,
                                      named_leaves, pspecs, shardings)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dist_tasks as tasks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TASKS = Path(tasks.__file__)
TOL = 1e-4          # the gradient tolerance of the port's train tests

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model"))]
KINDS = {"train": dict(kind="train"), "decode": dict(kind="decode"),
         "long_context": dict(kind="decode", long_context=True),
         "seq_shard": dict(kind="decode", seq_shard="model"),
         "no_fsdp": dict(kind="train", fsdp=False)}


# ---------------------------------------------------------------- spawning
def _start(tmp_path, task: str, world: int):
    """Start ``world`` ranks of ``task``; -> (procs, out paths)."""
    d = tmp_path / task
    d.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs, outs = [], []
    for r in range(world):
        out = d / f"out{r}.pt"
        procs.append(subprocess.Popen(
            [sys.executable, str(TASKS), task, str(r), str(world),
             str(d / "store"), str(out)],
            stdout=subprocess.DEVNULL, stderr=open(d / f"err{r}.txt", "w"),
            env=env, cwd=ROOT))
        outs.append(out)
    return procs, outs


def _join(procs, outs, timeout: float):
    """Every rank's output; a rank that fails or hangs fails the caller."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        err = outs[r].parent / f"err{r}.txt"
        assert p.returncode == 0, f"rank {r}: {err.read_text()[-3000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def _jax_subprocess(script: str, devices: int) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(script)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def _jax_result(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# ------------------------------------------------------------ spec parity
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_jax_for_every_leaf_mesh_and_rule_kind(arch):
    port, ref = build_model(ARCHS[arch]), jax_build_model(JAX_ARCHS[arch])
    trees = [(port.param_specs(), ref.param_specs()),
             (port.cache_specs(8, 4096), ref.cache_specs(8, 4096)),
             (port.cache_specs(1, 512), ref.cache_specs(1, 512))]
    checked = 0
    for shape, names in MESHES:
        desc, amesh = MeshDesc(names, shape), AbstractMesh(shape, names)
        for kind in KINDS.values():
            port_rules = tsh.make_rules(**kind)
            jax_rules = jsh.make_rules(**kind)
            assert port_rules == jax_rules
            for ptree, jtree in trees:
                got = tsh.pspec_for_specs(ptree, desc, port_rules)
                want = jsh.pspec_for_specs(jtree, amesh, jax_rules)
                # a mesh description serves JAX's functions as well
                assert jsh.pspec_for_specs(jtree, desc, jax_rules) == want
                for path, spec in named_leaves(got):
                    w = want
                    for k in path.split("/"):
                        w = w[k]
                    assert spec == tuple(w), (path, names, kind, spec, w)
                    checked += 1
    assert checked > 100


@pytest.mark.parametrize("arch", ["gemma-2b", "musicgen-medium",
                                  "phi-3-vision-4.2b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_batch_specs_equal_jax(arch, kind):
    for shape, names in MESHES:
        desc, amesh = MeshDesc(names, shape), AbstractMesh(shape, names)
        rules = tsh.make_rules("train")
        metas, placements = tsh.batch_specs(
            ARCHS[arch], ShapeConfig("c", 4096, 256, kind), desc, rules)
        jspecs, jshard = jsh.batch_specs(
            JAX_ARCHS[arch], JaxShape("c", 4096, 256, kind), amesh,
            jsh.make_rules("train"))
        assert sorted(metas) == sorted(jspecs)
        for k, m in metas.items():
            assert tuple(m.shape) == jspecs[k].shape
            assert str(m.dtype).split(".")[-1] == jspecs[k].dtype.name
            assert placements[k] == tsh.placements_for(
                tuple(jshard[k].spec), desc)


def test_logical_to_spec_uses_a_mesh_axis_once_and_shardings_follow_it():
    assert logical_to_spec(("fsdp", "batch", "model")) == \
        (("pod", "data"), None, "model")
    desc = make_production_mesh()
    assert desc.shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).sizes == (2, 16, 16)
    specs = build_model(ARCHS["gemma-2b"]).param_specs()
    ps = dict(named_leaves(pspecs(specs, DEFAULT_RULES, desc)))
    assert ps["blocks/attn/wq"] == (None, "data", "model", None)
    pl = dict(named_leaves(shardings(specs, desc)))
    from torch.distributed.tensor import Replicate, Shard
    assert pl["blocks/attn/wq"] == (Shard(1), Shard(2))
    assert pl["final_ln"] == (Replicate(), Replicate())
    # a tuple entry splits one dim over mesh dims in mesh order only
    pod = make_production_mesh(multi_pod=True)
    assert tsh.placements_for((("pod", "data"), None), pod) == \
        (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements_for((("data", "pod"),), pod)


# ------------------------------------------------------- gloo rank checks
PLACEMENT_SCRIPT = """
    import json
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_arch, reduce_for_smoke
    from repro.distributed.sharding import make_rules, spec_for
    from repro.models.model import build_model
    from repro.models.param import ParamSpec
    import jax.tree_util as tu
    specs = build_model(reduce_for_smoke(get_arch("gemma-2b"))).param_specs()
    flat = {"/".join(str(k.key) for k in path): s for path, s in
            tu.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, ParamSpec))[0]}
    out = {}
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 1), ("pod", "data", "model"))):
        devs = np.array(jax.devices()[:4]).reshape(shape)
        mesh = Mesh(devs, names)
        for p in %r:
            s = flat[p]
            spec = spec_for(s.shape, s.axes, mesh, make_rules("train"))
            idx = NamedSharding(mesh, spec).devices_indices_map(s.shape)
            out["/".join(names) + ":" + p] = [
                [[sl.start or 0, sl.stop if sl.stop is not None else n]
                 for sl, n in zip(idx[d], s.shape)]
                for d in jax.devices()[:4]]
    print(json.dumps(out))
""" % (tasks.PLACED,)

ALLREDUCE_SCRIPT = """
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.collectives import make_quantized_allreduce
    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 16)),
                    jnp.float32)
    out = make_quantized_allreduce(mesh, axis_name="pod")({"g": x})["g"]
    print(json.dumps(np.asarray(out).tolist()))
"""


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The two 4-rank runs, ``task_world4`` and ``task_model2``, side by
    side, each rank's outputs merged; the JAX placements; and the single-process references, made while
    the ranks run: each family's trained state after 1 and 3 steps, the sum
    of the learning rates those steps applied, and its served output."""
    tmp = tmp_path_factory.mktemp("world4")
    runs = [_start(tmp, task, 4) for task in ("world4", "model2")]
    jax_proc = _jax_subprocess(PLACEMENT_SCRIPT, 4)
    try:
        ref = {}
        for arch in tasks.ALL_ARCHS:
            for steps in (1, 3):
                t = Trainer(tasks.train_job(arch, steps, 1))
                ref[arch, steps] = dict(
                    tasks.trained(t.run(restore=False)),
                    lr_sum=sum(float(t.opt.learning_rate(torch.tensor(s)))
                               for s in range(1, steps + 1)))
            ref[arch, "serve"] = tasks.served(arch, 1)
        placements = _jax_result(jax_proc)
    finally:
        runs = [_join(procs, outs, timeout=900) for procs, outs in runs]
    results = []                     # each rank's two outputs, as one
    for a, b in zip(*runs):
        results.append({**a, **b, "model2": {**a["model2"], **b["model2"]}})
    return results, ref, placements


def _close(a, b, tol=TOL):
    """Within ``tol`` of ``b``'s largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= tol * max(np.abs(b).max(), 1e-6)))


def _same_training(got, want, arch):
    """A meshed run's losses, moments and parameters against one process's.

    The moments are held at TOL of their leaf's largest; those kept in
    bfloat16 at 2**-7 of it, bfloat16's spacing there at most, since each
    step rounds them to it.  A parameter moves by Adam's m / sqrt(v), about one
    learning rate a step.  Where an element's own first moment is smaller
    than its leaf's largest (a bias that starts at zero, a rope dimension
    that barely turns), its steps are known only to a relative
    tol * max|m| / |m|: the parameter is held at TOL of its leaf's largest
    plus that share of the steps' learning rates, at most 2 of them (the two
    runs' steps pointing apart).  A step misapplied on a shard moves an
    element by a whole learning rate where the moments are large.
    """
    assert _close(got["losses"], want["losses"]), arch
    tol = 2.0 ** -7 if get_arch(arch).adam_moment_dtype == "bfloat16" else TOL
    for path, w in want["moments"].items():
        assert _close(got["moments"][path], w, tol), (arch, path)
    for path, w in want["params"].items():
        m = np.abs(want["moments"]["m/" + path]).astype(np.float64)
        known = np.minimum(2.0, tol * m.max() / np.maximum(m, 1e-30))
        slack = TOL * np.abs(w).max() + want["lr_sum"] * known
        err = np.abs(np.asarray(got["params"][path], np.float64) - w)
        assert np.all(err <= slack), (arch, path, (err - slack).max())


def test_each_rank_holds_the_slice_jax_gives_its_device(world4):
    results, _, jax_idx = world4
    params = build_model(tasks.reduce_for_smoke(tasks.get_arch(
        "gemma-2b"))).init(torch.Generator().manual_seed(0), "cpu")
    full = {p: t.numpy() for p, t in named_leaves(params)}
    for key, per_device in jax_idx.items():
        names, path = key.split(":")
        for rank, bounds in enumerate(per_device):
            want = full[path][tuple(slice(a, b) for a, b in bounds)]
            got = results[rank]["shards"][tuple(names.split("/"))][path]
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_gqa_kernel_call_on_a_model_axis_wider_than_the_kv_heads(world4):
    results, _, _ = world4
    gqa = results[0]["gqa"]
    assert "Shard(dim=2)" not in gqa["kv_placements"]  # fit_spec left KV whole
    q, k, v = tasks.gqa_inputs()
    q.requires_grad_()
    k.requires_grad_()
    cfg = build_model(tasks.reduce_for_smoke(tasks.get_arch(
        "gemma-2b"))).cfg.with_(num_heads=4, num_kv_heads=2)
    o = attn.gqa_attend(q, k, v, cfg, impl="kernel")
    (o * o).sum().backward()
    np.testing.assert_allclose(gqa["out"], o.detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    assert _close(gqa["dq"], q.grad.numpy(), 1e-5)
    assert _close(gqa["dk"], k.grad.numpy(), 1e-5)


def _jax_cfg():
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduce_for_smoke as jax_reduce
    return jax_reduce(jax_get_arch("gemma-2b")).with_(
        num_heads=tasks.GQA["H"], num_kv_heads=tasks.GQA["Hkv"])


@pytest.mark.parametrize("impl", ["torch", "torch_pairs"])
def test_gqa_plain_impls_on_a_model_axis_wider_than_the_kv_heads(world4,
                                                                 impl):
    """The plain impls on 4 ranks at H=4, Hkv=2 (they split q's heads into
    (Hkv, G) and raised on the unevenly sharded dim): forward and gradients
    against one process and JAX's ``xla``/``xla_pairs`` branch."""
    import jax

    from repro.models import attention as jattn
    got = world4[0][0]["gqa_plain"][impl]
    q, k, v = tasks.gqa_inputs()
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = attn.gqa_attend(q, k, v, tasks.gqa_config(), impl=impl)
    (o * o).sum().backward()
    jimpl = impl.replace("torch", "xla")

    def loss(q, k, v):
        o = jattn.gqa_attend(q, k, v, _jax_cfg(), impl=jimpl)
        return (o * o).sum(), o
    (_, jo), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(t.detach().numpy()) for t in (q, k, v)))
    for want, grads in ((o.detach().numpy(), (q.grad, k.grad, v.grad)),
                        (np.asarray(jo), jgrads)):
        np.testing.assert_allclose(got["out"], want, rtol=2e-5, atol=2e-5)
        for name, g in zip(("dq", "dk", "dv"), grads):
            assert _close(got[name], np.asarray(g), TOL), (impl, name)


def _jax_decode(pos: int, window: int):
    from repro.models import attention as jattn
    inp = tasks.decode_inputs(pos)
    out, ck, cv = jattn.gqa_decode(
        {n: jnp.asarray(a) for n, a in inp["params"].items()},
        jnp.asarray(inp["x"]), jnp.asarray(inp["cache_k"]),
        jnp.asarray(inp["cache_v"]), jnp.int32(pos), _jax_cfg(),
        window=window, impl="xla")
    return np.asarray(out), np.asarray(ck), np.asarray(cv)


def _one_process_decode(impl: str, pos: int, window: int):
    inp = tasks.decode_inputs(pos)
    t = {n: torch.from_numpy(a) for n, a in inp["params"].items()}
    ck, cv = (torch.from_numpy(inp[n].copy()) for n in ("cache_k", "cache_v"))
    with torch.no_grad():
        out, ck, cv = attn.gqa_decode(t, torch.from_numpy(inp["x"]), ck, cv,
                                      pos, tasks.gqa_config(), window=window,
                                      impl=impl)
    return out.numpy(), ck.numpy(), cv.numpy()


def _same_decode(got, impl, pos, window):
    """A meshed decode's output and caches against one process and JAX's
    ``xla`` branch, at fp32 ``TOL`` 2e-5."""
    for want in (_one_process_decode(impl, pos, window),
                 _jax_decode(pos, window)):
        for name, w in zip(("out", "cache_k", "cache_v"), want):
            np.testing.assert_allclose(got[name], w, rtol=2e-5, atol=2e-5,
                                       err_msg=name)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_gqa_decode_on_a_model_axis_wider_than_the_kv_heads(world4, impl):
    """Decode's plain path on the GQA trap raised as the attend did."""
    for rank in world4[0]:
        got = rank["decode"][impl, 9, 0, "heads"]
        assert "Shard(dim=2)" not in got["placements"]
    _same_decode(world4[0][0]["decode"][impl, 9, 0, "heads"], impl, 9, 0)


@pytest.mark.parametrize("impl,pos,window", tasks.DECODE_CASES)
def test_gqa_decode_on_a_key_split_cache(world4, impl, pos, window):
    """``--seq-shard``'s rules split the cache's keys 4 ways: each rank's
    partial over its slice, merged by log-sum-exp, gives the whole
    cache's decode; only the rank that holds the slot writes it."""
    ranks = [r["decode"][impl, pos, window, "keys"] for r in world4[0]]
    T_loc = tasks.DECODE_T // 4
    slot = pos % window if window else pos
    for rank in ranks:
        assert rank["placements"] == "(Replicate(), Shard(dim=1))"
        changed, offset = rank["changed"]
        owner = offset <= slot < offset + T_loc
        assert changed == ([slot - offset] if owner else []), (rank, slot)
    assert sorted(r["changed"][1] for r in ranks) == [0, 4, 8, 12]
    _same_decode(ranks[0], impl, pos, window)


def test_mla_decode_writes_a_key_split_latent_cache(world4):
    """MLA's latent caches split over their keys by --seq-shard's rules:
    the token's latents land in the shard that holds ``pos`` (DTensor's
    ``cache[:, pos] = ...`` wrote into a gathered copy, and the shards kept
    their old rows), and the output matches one process and JAX."""
    got = world4[0][0]["mla_decode"]
    assert got["placements"] == "(Replicate(), Shard(dim=1))"
    _same_mla_decode(got, 9, 2e-5)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("pos", tasks.MLA_POSITIONS)
def test_mla_decode_on_a_key_split_cache(world4, mesh, pos):
    """``mla_decode`` on latent caches whose keys "model" splits: each rank's
    absorbed partial over its slice, merged by log-sum-exp before W_uv,
    gives JAX's decode and the meshless port's to 1e-5, the token's latents
    in the shard that holds ``pos``."""
    got = world4[0][0]["mla_key_split"][mesh, pos]
    want = "(Replicate(), Shard(dim=1))" if mesh == (1, 4) else \
        "(Shard(dim=0), Shard(dim=1))"
    assert got["placements"] == want
    _same_mla_decode(got, pos, 1e-5)


@pytest.mark.parametrize("pos", tasks.MLA_POSITIONS)
def test_mla_decode_under_the_decode_rules(world4, pos):
    """``mla_decode`` on (2, 2) under the decode rules, x's d split over
    "model" as a decode step hands it to the layer, so that the rope query
    is a pending sum, reduced on the query (not on the scores): JAX's decode
    and the meshless port's to 1e-5, the caches split over the batch
    only."""
    got = world4[0][0]["mla_decode_rules"][pos]
    assert got["placements"] == "(Shard(dim=0), Replicate())"
    _same_mla_decode(got, pos, 1e-5)


def _same_mla_decode(got, pos: int, tol: float) -> None:
    """A meshed ``mla_decode`` of ``tasks.mla_inputs(pos)`` (output and
    caches, whole) against the meshless port's and JAX's."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduce_for_smoke as jax_reduce
    from repro.models import attention as jattn
    inp = tasks.mla_inputs(pos)
    cfg = tasks.reduce_for_smoke(tasks.get_arch("deepseek-v3-671b"))
    ckv, kr = (torch.from_numpy(inp[n].copy()) for n in ("ckv", "kr"))
    with torch.no_grad():
        one = attn.mla_decode({n: torch.from_numpy(a) for n, a in
                               inp["params"].items()},
                              torch.from_numpy(inp["x"]), ckv, kr, pos, cfg)
    jax_out = jattn.mla_decode(
        {n: jnp.asarray(a) for n, a in inp["params"].items()},
        jnp.asarray(inp["x"]), jnp.asarray(inp["ckv"]), jnp.asarray(inp["kr"]),
        jnp.int32(pos), jax_reduce(jax_get_arch("deepseek-v3-671b")))
    for want in ([t.numpy() for t in one], [np.asarray(t) for t in jax_out]):
        for name, w in zip(("out", "ckv", "kr"), want):
            np.testing.assert_allclose(got[name], w, rtol=tol, atol=tol,
                                       err_msg=name)


def test_ssd_per_shard_with_one_group_on_a_model_axis_of_4(world4):
    """A smoke mamba2 layer on a (1, 4) mesh through ``ssd_per_shard``:
    each rank's scan is handed its 4 of the 16 heads and the one B/C group
    they all read, once (G = 1), the convolution run on their x channels
    and every B/C channel.  The output and the final state match the
    meshless port's to 1e-5 and JAX's ``mamba2_forward`` to ``ssd``'s 2e-4,
    the gradients of u and of every parameter (dB and dC summed by the
    reduce-scatter of the projection's gradient) the port's to 1e-5 and
    JAX's to 1e-4 of their largest."""
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduce_for_smoke as jax_reduce
    from repro.models import ssm as jax_ssm
    from repro_torch.models.ssm import mamba2_forward
    for rank in world4[0]:
        assert rank["ssd_per_shard"]["handed"] == [(4, 1)]
    got = world4[0][0]["ssd_per_shard"]
    inp = tasks.layer_inputs()
    cfg = tasks.reduce_for_smoke(tasks.get_arch("mamba2-1.3b"))
    params = {k: torch.from_numpy(a).requires_grad_()
              for k, a in inp["params"].items()}
    u = torch.from_numpy(inp["u"]).requires_grad_()
    y, st = mamba2_forward(params, u, cfg, return_state=True)
    ((y * torch.from_numpy(inp["gy"])).sum()
     + (st * torch.from_numpy(inp["gst"])).sum()).backward()
    jcfg = jax_reduce(jax_get_arch("mamba2-1.3b"))

    def loss(p, u):
        y, st = jax_ssm.mamba2_forward(p, u, jcfg, return_state=True)
        return jnp.sum(y * inp["gy"]) + jnp.sum(st * inp["gst"]), (y, st)
    (jp, ju), (jy, jst) = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(a) for k, a in inp["params"].items()},
        jnp.asarray(inp["u"]))
    jgrads = {"u": ju, **jp}
    for want, tol in (((y, st), 1e-5), ((jy, jst), 2e-4)):
        for name, w in zip(("y", "state"), want):
            w = np.asarray(w.detach() if hasattr(w, "detach") else w)
            assert _close(got[name], w, tol), (name, tol)
    for k, g in got["grads"].items():
        one = (u if k == "u" else params[k]).grad.numpy()
        assert _close(g, one, 1e-5), k
        assert _close(g, np.asarray(jgrads[k]), 1e-4), k


def test_mamba2_gradient_on_2x2_sums_only_the_projections_split(world4):
    """A smoke mamba2 loss and gradient on (2, 2) under the train rules
    (4 layers, 16 heads, one B/C group): each rank's scans' dx, and dB and
    dC summed over the model ranks, equal one process's to ``ssd``'s 2e-4.
    The backward's collectives, exactly: a layer's only reductions over
    "model" are the reduce-scatter of its projection's gradient (B/data,
    S, proj_out/model), which sums dB and dC with the rest, the gated
    norm's (B/data, S, 1) and the residual stream's (B/data, S, d) (each
    rank's heads' share of its input's gradient); no all-reduce carries
    the (B/data, S, conv_dim) gradient of the convolution's input, which
    the layer all-reduced whole.  The rest are the parameters' sums over
    "data" (conv_w and conv_b, then reduce-scattered over "model"), the
    fsdp reduce-scatters and the embedding's."""
    want = tasks.ssm_grads()
    cfg = tasks.reduce_for_smoke(tasks.get_arch("mamba2-1.3b"))
    ranks = sorted(world4[0], key=lambda r: r["ssm_grads"]["coord"])
    got = [r["ssm_grads"] for r in ranks]          # (data, model) order
    for layer, w in enumerate(want["scans"]):
        part = lambda i, j, k: got[2 * i + j]["scans"][layer][k]
        dx = np.concatenate([np.concatenate([part(i, j, "dx") for j in (0, 1)],
                                            axis=2) for i in (0, 1)])
        assert _close(dx, w["dx"], 2e-4), layer
        for k in ("dB", "dC"):
            summed = np.concatenate([part(i, 0, k) + part(i, 1, k)
                                     for i in (0, 1)])
            assert _close(summed, w[k], 2e-4), (layer, k)
    s, L, d, V = cfg.ssm, cfg.num_layers, cfg.d_model, cfg.padded_vocab
    d_in, K = cfg.expand_dim, s.conv_kernel
    conv = d_in + 2 * s.n_groups * s.d_state
    proj = 2 * d_in + 2 * s.n_groups * s.d_state + cfg.ssm_heads
    tok, f32 = 4 // 2 * 64, 4
    # the residual stream's L and the lookup's; conv_w's, conv_b's and
    # the norm's L each
    all_reduce = (L + 1) * tok * d + L * (K * conv + conv + tok)
    reduce_scatter = L * (tok * proj // 2             # the projection
                          + d // 2 * proj // 2 + d_in // 2 * d // 2
                          + K * conv // 2 + conv // 2) + V // 2 * d // 2
    for r in got:
        assert r["count"] == {"all-reduce": (L + 1) + 3 * L,
                              "reduce-scatter": 5 * L + 1}, r["count"]
        assert r["bytes"] == {
            "all-reduce": f32 * all_reduce,
            "reduce-scatter": f32 * reduce_scatter}, r["bytes"]


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v3-671b"])
def test_decode_hidden_state_is_whole_over_model_on_1x4(world4, arch):
    """A smoke decode step served on (1, 4): the hidden state each layer
    hands the next is placed ``Replicate`` on "model" on every rank, and
    the step sends exactly: one all-reduce of the looked-up rows and two a
    layer (after the attention, after the MLP or MoE), each (B, 1, d);
    deepseek-v3's 3 MoE layers one more of their (B * top_k, d) rows over
    the experts' ranks; and the all-gather of the (B, V/4) logits."""
    cfg = tasks.reduce_for_smoke(tasks.get_arch(arch))
    B, f32 = 2, 4
    moe = cfg.num_layers - cfg.moe.first_dense_layers if cfg.moe else 0
    want_count = {"all-reduce": 1 + 2 * cfg.num_layers + moe,
                  "all-gather": 1}
    rows = B * cfg.d_model * (1 + 2 * cfg.num_layers)
    experts = moe * B * cfg.moe.top_k * cfg.d_model if moe else 0
    want_bytes = {"all-reduce": f32 * (rows + experts),
                  "all-gather": f32 * B * cfg.padded_vocab}
    for rank in world4[0]:
        got = rank["decode_counted"][arch]
        assert got["placements"] == \
            ["(Replicate(), Replicate())"] * cfg.num_layers
        assert got["count"] == want_count, got
        assert got["bytes"] == want_bytes, got


@pytest.mark.parametrize("model_axis", [4, 2], ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", tasks.MAMBA_DECODE_ARCHS)
def test_mamba_decode_step_on_each_ranks_heads(world4, arch, model_axis):
    """Two smoke decode steps served on (1, 4) and (2, 2): each mamba
    layer sends exactly two all-gathers, the projection's (B/data, 1,
    proj_out) row and the convolution's output row (B/data, 1, conv_dim),
    and two all-reduces, the gated norm's (B/data, 1, 1) sum of squares
    and the output's (B/data, 1, d) pending sum; the fp32 SSM state is
    never gathered.  On (1, 4) the whole step adds only the lookup's
    all-reduce, two a shared-block invocation (zamba2) and the logits'
    all-gather; on (2, 2) it also gathers each layer's fsdp shards before
    the layer.  The state and conv caches keep their specs' placements,
    and each rank's shards of them, written in place, equal the matching
    slices of the meshless port's caches to 2e-5."""
    cfg = tasks.reduce_for_smoke(tasks.get_arch(arch))
    s, d = cfg.ssm, cfg.d_model
    conv = cfg.expand_dim + 2 * s.n_groups * s.d_state
    proj = 2 * cfg.expand_dim + 2 * s.n_groups * s.d_state + cfg.ssm_heads
    f32, B = 4, 2 // (4 // model_axis)          # the batch rows a rank holds
    layers = cfg.num_layers if cfg.family == "ssm" else \
        cfg.num_layers // cfg.hybrid.shared_attn_period * \
        cfg.hybrid.shared_attn_period
    want_layer = {"count": {"all-gather": 2 * layers,
                            "all-reduce": 2 * layers},
                  "by_kind": {"all-gather": f32 * layers * B * (proj + conv),
                              "all-reduce": f32 * layers * B * (1 + d)}}
    state_bytes = f32 * 2 * cfg.ssm_heads * s.d_state * s.head_dim
    shared = cfg.num_layers // cfg.hybrid.shared_attn_period \
        if cfg.family == "hybrid" else 0
    ref = tasks.Server(tasks.serve_job(arch, 1))
    cache = ref.model.init_cache(2, 6, "cpu")
    tokens = np.random.default_rng(6).integers(0, 512, (2, 6))
    with torch.no_grad():
        for t in range(2):
            ref._step(cache, np.ascontiguousarray(tokens[:, t]), t)
    for rank in world4[0]:
        got = rank["mamba_decode"][arch, model_axis]
        assert got["mesh"] == (4 // model_axis, model_axis)
        assert got["layer"] == want_layer, got["layer"]
        if model_axis == 4:
            assert got["count"] == {"all-gather": 2 * layers + 1,
                                    "all-reduce": 1 + 2 * layers
                                    + 2 * shared}, got["count"]
            assert got["largest"] < state_bytes, got["largest"]
        for name in ("state", "conv"):
            leaf = got[name]
            assert leaf["placements"] == leaf["spec_placements"], name
            want = cache[name].numpy()[tuple(
                slice(o, o + n) for o, n in zip(leaf["offset"],
                                                leaf["local"].shape))]
            assert _close(leaf["local"], want, 2e-5), (name, leaf["offset"])


@pytest.mark.parametrize("impl", tasks.GQA_IMPLS)
@pytest.mark.parametrize("name", sorted(tasks.GQA_GROUPS))
def test_gqa_hands_each_rank_its_kv_groups_on_a_model_axis_of_4(world4,
                                                                name, impl):
    """(1, 4), the KV heads whole (they do not divide "model"): where a
    rank's query heads all read one group (H=8, Hkv=1) its attention is
    handed that one KV head; where they straddle groups (H=12, Hkv=3), a
    copy for each of its 3 heads.  Forward and gradients against one
    process and JAX's ``xla`` (``xla_pairs``) branch to 1e-5."""
    import jax

    from repro.models import attention as jattn
    heads = tasks.GQA_GROUPS[name]
    want_handed = 1 if name == "one_group" else heads["H"] // 4
    for rank in world4[0]:
        got = rank["gqa_groups"][name, impl]
        assert got["handed"] == [want_handed], (name, impl, got["handed"])
        assert "Shard(dim=2)" not in got["kv_placements"]
    got = world4[0][0]["gqa_groups"][name, impl]
    q, k, v = (t.requires_grad_() for t in tasks.gqa_group_inputs(**heads))
    cfg = tasks.gqa_config().with_(num_heads=heads["H"],
                                   num_kv_heads=heads["Hkv"])
    o = attn.gqa_attend(q, k, v, cfg, impl=impl)
    (o * o).sum().backward()
    jcfg = _jax_cfg().with_(num_heads=heads["H"], num_kv_heads=heads["Hkv"])
    jimpl = "xla_pairs" if impl == "torch_pairs" else "xla"

    def loss(q, k, v):
        o = jattn.gqa_attend(q, k, v, jcfg, impl=jimpl)
        return (o * o).sum(), o
    (_, jo), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(t.detach().numpy()) for t in (q, k, v)))
    for want, grads in ((o.detach().numpy(), (q.grad, k.grad, v.grad)),
                        (np.asarray(jo), jgrads)):
        assert _close(got["out"], want, 1e-5), (name, impl)
        for n, g in zip(("dq", "dk", "dv"), grads):
            assert _close(got[n], np.asarray(g), 1e-5), (name, impl, n)


@pytest.mark.parametrize("arch", tasks.MESH_SERVE_ARCHS)
def test_server_on_a_model_axis_of_4_gives_the_meshless_decode(world4, arch):
    """The serving rules on (1, 4) split the embedding table over its vocab
    only: each rank looks its tokens up in its own shard (DTensor's lookup
    moved the whole table to a split along d every token).  Six decode
    steps' logits within 1e-5 of the meshless server's, greedy tokens
    equal on every rank."""
    results, ref, _ = world4
    want = tasks.decode_logits(tasks.Server(tasks.serve_job(arch, 1)))
    assert _close(results[0]["decode_1x4"][arch], want, 1e-5), arch
    for out in results:
        np.testing.assert_array_equal(out["serve_1x4"][arch],
                                      ref[arch, "serve"], err_msg=arch)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", tasks.MESH_SERVE_ARCHS)
def test_prefill_on_a_mesh_gives_the_meshless_outputs(world4, arch, mesh):
    """``Model.prefill`` under the prefill rules, the lookup on each rank's
    vocab shard with no gradient: the last token's logits and every cache
    leaf within 1e-5 of one process's."""
    got = world4[0][0]["prefill"][mesh, arch]
    want = tasks.prefilled(arch)
    assert _close(got["logits"], want["logits"], 1e-5), arch
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, w in want["cache"].items():
        assert _close(got["cache"][k], w, 1e-5), (arch, k)


@pytest.mark.parametrize("impl,pos,window", tasks.DECODE_CASES_2D)
def test_gqa_decode_on_a_cache_split_over_two_mesh_dims(world4, impl, pos,
                                                        window):
    """The long-context rules split the keys over ("pod", "data") on a
    (2, 2, 1) mesh: the merge runs over both mesh dims, and q arrives as a
    pending sum (its projection contracts the fsdp-split d_model)."""
    ranks = [r["decode"][impl, pos, window, "keys_2d"] for r in world4[0]]
    slot = pos % window if window else pos
    for rank in ranks:
        assert rank["placements"] == \
            "(Shard(dim=1), Shard(dim=1), Replicate())"
        changed, offset = rank["changed"]
        owner = offset <= slot < offset + 4
        assert changed == ([slot - offset] if owner else []), (rank, slot)
    assert sorted(r["changed"][1] for r in ranks) == [0, 4, 8, 12]
    _same_decode(ranks[0], impl, pos, window)


@pytest.mark.parametrize("arch", tasks.ALL_ARCHS)
def test_trainer_on_data2_model2_matches_one_process(world4, arch):
    results, ref, _ = world4
    for out in results:              # every rank returns the same history
        got = out["model2"][arch]
        assert got["mesh"] == (2, 2)
        assert _close(got["losses"], ref[arch, 3]["losses"])
    _same_training(results[0]["model2"][arch], ref[arch, 3], arch)


@pytest.mark.parametrize("arch", tasks.ALL_ARCHS)
def test_trainer_on_data4_matches_one_process(world4, arch):
    """One step: its loss is taken before the update, so the moments and
    parameters after it hold the gradient reduce-scatter and the optimizer
    on shards against one process."""
    results, ref, _ = world4
    for out in results:
        assert _close(out["data4"][arch]["losses"], ref[arch, 1]["losses"])
    _same_training(results[0]["data4"][arch], ref[arch, 1], arch)


def test_elastic_restore_across_world_sizes_is_bit_exact(world4):
    results, _, _ = world4
    saved = results[0]["saved"]
    for rank in (0, 1):
        restored = results[rank]["restored2"]
        assert sorted(restored) == sorted(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(restored[k], v, err_msg=k)
    # on (2, 1) the embedding's fsdp dim is split over the 2 data ranks
    shape = results[0]["restored2_local"]["params/embed"]
    assert tuple(shape) == (saved["params/embed"].shape[0],
                            saved["params/embed"].shape[1] // 2)
    for k, v in saved.items():
        np.testing.assert_array_equal(results[0]["restored0"][k], v,
                                      err_msg=k)
    assert "restored2" not in results[2]


def test_server_on_data2_model2_gives_the_meshless_tokens(world4):
    """Every family: greedy tokens equal; for musicgen, whose codebooks
    ``generate`` does not take, its decode logits within 1e-5 of their
    largest."""
    results, ref, _ = world4
    for arch in tasks.ALL_ARCHS:
        want = ref[arch, "serve"]
        for out in results:
            got = out["serve"][arch]
            if want.dtype == np.int32:
                np.testing.assert_array_equal(got, want, err_msg=arch)
            else:
                assert got.shape == want.shape
                assert _close(got, want, 1e-5), arch


def test_server_on_a_world_of_two_gives_the_meshless_tokens(tmp_path):
    procs, outs = _start(tmp_path, "serve2", 2)
    try:
        want = tasks.served("granite-moe-1b-a400m", 1)
    finally:
        results = _join(procs, outs, timeout=400)
    for out in results:
        assert out["mesh"] == (1, 2)
        np.testing.assert_array_equal(out["serve"], want)


def test_quantized_allreduce_matches_jax_shard_map(tmp_path):
    procs, outs = _start(tmp_path, "allreduce", 8)
    jax_proc = _jax_subprocess(ALLREDUCE_SCRIPT, 8)
    try:
        want = np.asarray(_jax_result(jax_proc), np.float32)
    finally:
        results = _join(procs, outs, timeout=400)
    x = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    mean = x.reshape(2, 4, 16).mean(axis=0)
    for out in results:
        got = out["allreduce"]
        assert got.shape == want.shape == (4, 16)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        for y in (got, want):
            assert np.abs(y - mean).max() / np.abs(mean).max() < 0.05
        assert out["wire"] == (jax_wire({"g": jnp.asarray(x)}, True),
                               jax_wire({"g": jnp.asarray(x)}, False))


def test_quantized_psum_of_one_rank_is_jax_formula_in_numpy(tmp_path):
    """In a world of one the int8 mean is the dequantized input: JAX's
    formula in numpy."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import quantized_psum
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        x = np.random.default_rng(1).standard_normal((5, 7)).astype(
            np.float32)
        got = quantized_psum(torch.from_numpy(x)).numpy()
    finally:
        dist.destroy_process_group()
    scale = np.float32(np.abs(x).max() + np.float32(1e-12)) / np.float32(127)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32)
    want = (q.astype(np.float32) * scale).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(x).max())
