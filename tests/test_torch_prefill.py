"""The port's prefill on the CPU against the JAX package's: the block-pair
schedule and query offset of ``blockwise_attention``, ``gqa_prefill`` and
``mla_prefill``, ``ssm_lib_prefill``, and ``Model.prefill`` for every smoke
architecture, logits and every cache leaf by path.

The JAX references run as its own tests run them: ``build_model(cfg)`` with
``attn_impl`` ``"xla"``, ``"xla_pairs"`` or ``"pallas_interpret"`` (the
flash kernel in interpret mode).  Weights are drawn once in JAX, passed
through numpy and carried into the port by path (``from_numpy_tree``), as
``tests/test_torch_serve.py`` does.  Tolerances: attention outputs at 2e-5
in fp32 (``tests/test_kernels.py``'s ``TOL``); layer outputs and caches at
1e-4 of their largest magnitude, the ssm layer at 2e-4 (the ssd tolerance);
prefill logits at 1e-4 of the largest logit (``DECODE_RTOL`` of
``tests/test_torch_serve.py``); prefill against the train forward at 2e-2
(``tests/test_models.py``, at its dropless capacity factor for moe).
Prefill followed by decode is in ``tests/test_torch_prefill_decode.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce_for_smoke
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build_model
from repro.models.param import materialize as jax_materialize
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention as attn
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.models import model as model_lib
from repro_torch.models.layers import rmsnorm

TOL = 2e-5
RTOL = 1e-4
SSD_TOL = 2e-4
DECODE_RTOL = 1e-4
FORWARD_RTOL = 2e-2
ALL_ARCHS = ["deepseek-v3-671b", "gemma-2b", "gemma3-27b",
             "granite-moe-1b-a400m", "mamba2-1.3b", "musicgen-medium",
             "phi-3-vision-4.2b", "qwen2-72b", "starcoder2-3b", "zamba2-2.7b"]
# the port's impls; JAX's pallas_interpret, xla and xla_pairs are their
# counterparts
IMPLS = ["kernel", "torch", "torch_pairs"]


def _configs(arch, dropless=False, **kw):
    jcfg = jax_reduce_for_smoke(jax_get_arch(arch)).with_(**kw)
    cfg = reduce_for_smoke(get_arch(arch)).with_(**kw)
    if dropless and cfg.moe:   # tests/test_models.py:60-61
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                  capacity_factor=16.0))
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _perturb(tree, seed):
    """Constant leaves (norm scales, biases, D) get noise so that the
    comparison sees them."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a.astype(np.float32)
                    + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(perturb, tree)


def _batch(cfg, B, S, seed, image=True):
    """numpy tokens (B,S) or (B,K,S) [and image embeds]."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.num_image_tokens and image:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, 1024)).astype(np.float32)
    return batch


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


# ------------------------------------------------- blockwise_attention
def _qkv(B, S, T, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]


# (B, S, T, H, Hkv, D, window, q_offset, pairs, block): a query offset with
# S < T, GQA, a window, S and T no multiple of the block; the pair schedule
# with S no multiple of the block, GQA and a window; pairs with a query
# offset (ignored in both packages); pairs asked for where S != T (the full
# schedule, with the offset)
BLOCKWISE = [
    (2, 40, 100, 4, 2, 16, 0, 60, False, 16),
    (1, 40, 100, 4, 1, 16, 24, 60, False, 16),
    (2, 33, 70, 6, 3, 8, 0, 37, False, 32),
    (2, 100, 100, 4, 2, 16, 0, 0, True, 32),
    (1, 100, 100, 4, 1, 16, 40, 0, True, 32),
    (2, 96, 96, 8, 2, 16, 20, 0, True, 16),
    (1, 64, 64, 4, 2, 16, 0, 5, True, 16),
    (1, 40, 100, 4, 2, 16, 0, 60, True, 16),
]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,window,q_offset,pairs,block",
                         BLOCKWISE)
def test_blockwise_attention_matches_jax(B, S, T, H, Hkv, D, window, q_offset,
                                         pairs, block):
    q, k, v = _qkv(B, S, T, H, Hkv, D, seed=S + T + window)
    kw = dict(scale=1.0 / np.sqrt(D), causal=True, window=window,
              q_block=block, kv_block=block, pairs=pairs, q_offset=q_offset)
    want = jax_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attn.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_pairs_schedule_equals_the_full_one():
    """The pair schedule skips only blocks the causal mask hides, so the
    two schedules agree within rounding, and the gradient flows through the
    carried states."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(2, 100, 100, 4, 2, 16, seed=9))
    kw = dict(scale=0.25, window=30, q_block=32, kv_block=32)
    full = attn.blockwise_attention(q, k, v, **kw)
    pairs = attn.blockwise_attention(q, k, v, pairs=True, **kw)
    torch.testing.assert_close(pairs, full, atol=TOL, rtol=TOL)
    g_full = torch.autograd.grad(full.sum(), (q, k, v))
    g_pairs = torch.autograd.grad(pairs.sum(), (q, k, v))
    for a, b in zip(g_pairs, g_full):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("q_offset", [0, 7, 31])
def test_query_offset_is_a_suffix_of_the_full_attention(q_offset):
    """Queries at positions q_offset.. against keys 0..T-1 give the rows
    q_offset.. of the attention of every position."""
    T = q_offset + 33
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, T, T, 4, 2, 8, seed=3))
    kw = dict(scale=0.3, window=12, q_block=16, kv_block=16)
    full = attn.blockwise_attention(q, k, v, **kw)
    part = attn.blockwise_attention(q[:, q_offset:], k, v, q_offset=q_offset,
                                    **kw)
    torch.testing.assert_close(part, full[:, q_offset:], atol=TOL, rtol=TOL)


# ------------------------------------------------------------ layer prefill
@functools.lru_cache(maxsize=None)
def _gqa_layer(window):
    """A smoke-size GQA layer (H=4, Hkv=2) and x of 1024 tokens: two
    512-row blocks, so the pair schedule skips one (JAX's flash kernel takes
    no S that is not a multiple of its 512-key block)."""
    jcfg, cfg = _configs("gemma-2b", num_kv_heads=2)
    specs = jax_attn.gqa_specs(jcfg)
    params = _perturb(jax.tree_util.tree_map(
        np.asarray, jax_materialize(specs, jax.random.PRNGKey(5))), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 1024, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1024, dtype=np.int32), (1, 1024)).copy()
    return jcfg, cfg, params, x, pos


@functools.lru_cache(maxsize=None)
def _jax_gqa_prefill(window, jax_impl):
    jcfg, _, params, x, pos = _gqa_layer(window)
    out, (k, v) = jax.jit(functools.partial(
        jax_attn.gqa_prefill, cfg=jcfg, window=window, impl=jax_impl))(
        _jt(params), jnp.asarray(x), jnp.asarray(pos))
    return np.asarray(out), np.asarray(k), np.asarray(v)


@pytest.mark.parametrize("jax_impl", ["xla", "xla_pairs", "pallas_interpret"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("window", [0, 300])
def test_gqa_prefill_matches_jax(window, impl, jax_impl):
    _, cfg, params, x, pos = _gqa_layer(window)
    want = _jax_gqa_prefill(window, jax_impl)
    tp = from_numpy_tree(params, "cpu")
    out, (k, v) = attn.gqa_prefill(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), cfg, window=window,
                                   impl=impl)
    assert k.shape[1] == (window or x.shape[1])
    for name, g, w in zip(("out", "k", "v"), (out, k, v), want):
        assert _rel(g, w) <= RTOL, (name, _rel(g, w))


@functools.lru_cache(maxsize=None)
def _mla_layer():
    """deepseek-v3's smoke MLA layer and x of 640 tokens: two blocks, the
    second padded."""
    jcfg, cfg = _configs("deepseek-v3-671b")
    specs = jax_attn.mla_specs(jcfg)
    params = _perturb(jax.tree_util.tree_map(
        np.asarray, jax_materialize(specs, jax.random.PRNGKey(7))), seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 640, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(640, dtype=np.int32), (1, 640)).copy()
    return jcfg, cfg, params, x, pos


@functools.lru_cache(maxsize=None)
def _jax_mla_prefill(jax_impl):
    jcfg, _, params, x, pos = _mla_layer()
    out, (ckv, kr) = jax.jit(functools.partial(
        jax_attn.mla_prefill, cfg=jcfg, impl=jax_impl))(
        _jt(params), jnp.asarray(x), jnp.asarray(pos))
    return np.asarray(out), np.asarray(ckv), np.asarray(kr)


@pytest.mark.parametrize("jax_impl", ["xla", "xla_pairs"])
@pytest.mark.parametrize("impl", IMPLS)
def test_mla_prefill_matches_jax(impl, jax_impl):
    """MLA runs the plain blockwise attention under every impl, in both
    packages; the cache is the latents."""
    _, cfg, params, x, pos = _mla_layer()
    want = _jax_mla_prefill(jax_impl)
    out, (ckv, kr) = attn.mla_prefill(from_numpy_tree(params, "cpu"),
                                      torch.from_numpy(x),
                                      torch.from_numpy(pos), cfg, impl=impl)
    assert ckv.shape == (1, 640, cfg.mla.kv_lora_rank)
    for name, g, w in zip(("out", "ckv", "kr"), (out, ckv, kr), want):
        assert _rel(g, w) <= RTOL, (name, _rel(g, w))


def test_mla_train_pairs_matches_jax_pairs():
    jcfg, cfg, params, x, pos = _mla_layer()
    want = jax.jit(functools.partial(jax_attn.mla_train, cfg=jcfg,
                                     impl="xla_pairs"))(
        _jt(params), jnp.asarray(x), jnp.asarray(pos))
    got = attn.mla_train(from_numpy_tree(params, "cpu"), torch.from_numpy(x),
                         torch.from_numpy(pos), cfg, impl="torch_pairs")
    assert _rel(got, want) <= RTOL


# ------------------------------------------------------------- ssm prefill
@functools.lru_cache(maxsize=None)
def _ssm_layer(arch):
    jcfg, cfg = _configs(arch)
    specs = jax_ssm.ssm_specs(jcfg)
    params = _perturb(jax.tree_util.tree_map(
        np.asarray, jax_materialize(specs, jax.random.PRNGKey(9))), seed=9)
    return jcfg, cfg, params


@pytest.mark.parametrize("S", [1, 2, 3, 32, 96])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_lib_prefill_matches_jax(arch, S):
    """Output, final state and conv tail; S of 1 and 2 are shorter than the
    tail (K-1 = 3), which is then left-padded with zeros."""
    jcfg, cfg, params = _ssm_layer(arch)
    hn = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want = jax_model.ssm_lib_prefill(_jt(params), jnp.asarray(hn), jcfg, "xla")
    got = model_lib.ssm_lib_prefill(from_numpy_tree(params, "cpu"),
                                    torch.from_numpy(hn), cfg, "kernel")
    K = cfg.ssm.conv_kernel
    assert got[2].shape == (2, K - 1, cfg.expand_dim
                            + 2 * cfg.ssm.n_groups * cfg.ssm.d_state)
    assert got[1].dtype == torch.float32
    if S < K - 1:
        assert not got[2][:, :K - 1 - S].any()
    for name, g, w in zip(("out", "state", "conv"), got, want):
        assert _rel(g, w) <= SSD_TOL, (name, _rel(g, w))


def test_ssm_block_maps_every_plain_impl_to_ssd_chunked():
    """The mamba layers of the train forward scan through ``ssd_chunked``
    under ``torch_pairs`` as under ``torch`` (JAX maps every impl but
    pallas to xla); an impl neither package has raises."""
    _, cfg = _configs("mamba2-1.3b")
    tokens = torch.from_numpy(_batch(cfg, 2, 64, seed=1)["tokens"])
    batch = {"tokens": tokens, "targets": tokens}
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    losses = [build_model(cfg, attn_impl=impl).loss_fn(params, batch)[0]
              for impl in ("torch", "torch_pairs")]
    assert torch.equal(losses[0], losses[1])
    with pytest.raises(ValueError, match="unknown attention impl"):
        build_model(cfg, attn_impl="xla")


# ------------------------------------------------------------ Model.prefill
PREFILL_S = 96


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, cfg = _configs(arch)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(1))), seed=1)
    return jcfg, cfg, np_params


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch):
    jcfg, cfg, np_params = _model(arch)
    batch = _batch(cfg, 2, PREFILL_S, seed=2)
    logits, cache = jax.jit(jax_build_model(jcfg).prefill)(_jt(np_params),
                                                           _jt(batch))
    return np.asarray(logits), dict(named_leaves(
        jax.tree_util.tree_map(np.asarray, cache)))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_prefill_matches_jax(arch, impl):
    """Logits and every cache leaf by path, shape and dtype, against JAX's
    ``model.prefill``; the cache has the paths, shapes and dtypes of
    ``cache_specs(B, S)``.  vlm prefills with its image embeddings."""
    _, cfg, np_params = _model(arch)
    want_logits, want_cache = _jax_prefill(arch)
    model = build_model(cfg, attn_impl=impl)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    logits, cache = make_prefill_step(model)(
        params, _tt(_batch(cfg, 2, PREFILL_S, seed=2)))
    assert _rel(logits, want_logits) <= DECODE_RTOL
    got = dict(named_leaves(cache))
    assert sorted(got) == sorted(want_cache)
    specs = dict(named_leaves(model.cache_specs(2, PREFILL_S)))
    for path, leaf in got.items():
        assert tuple(leaf.shape) == specs[path].shape, path
        assert str(leaf.dtype) == f"torch.{specs[path].dtype}", path
        assert leaf.is_inference(), path
        assert _rel(leaf, want_cache[path]) <= RTOL, (path,
                                                      _rel(leaf,
                                                           want_cache[path]))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_prefill_matches_forward(arch):
    """tests/test_models.py's rule on the port: the last logits of prefill
    against the train forward's, within 2e-2, moe at its dropless capacity,
    vlm as text."""
    _, cfg = _configs(arch, dropless=True)
    model = build_model(cfg, attn_impl="kernel")
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    S = 32
    batch = _tt(_batch(cfg, 2, S, seed=3, image=False))
    with torch.no_grad():
        positions = torch.arange(S, dtype=torch.int32).expand(2, S)
        h = model.backbone(params, model._embed_tokens(params, batch),
                           positions)
        want = model._logits(params, rmsnorm(params["final_ln"], h,
                                             cfg.norm_eps))[:, -1]
    got, _ = make_prefill_step(model)(params, batch)
    assert got.shape == want.shape
    assert _rel(got, want) < FORWARD_RTOL, arch


@pytest.fixture(scope="module")
def full_width_gemma():
    """gemma-2b at full width (d=2048, 8 heads, MQA, head_dim 256, d_ff
    16384) cut to one layer and a 512-entry vocab, in fp32."""
    cut = dict(num_layers=1, vocab_size=512, dtype="float32")
    jcfg = jax_get_arch("gemma-2b").with_(**cut)
    cfg = get_arch("gemma-2b").with_(**cut)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(3))), seed=3)
    return jcfg, cfg, np_params


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_full_width_gemma_prefill_matches_jax(full_width_gemma, jax_impl):
    jcfg, cfg, np_params = full_width_gemma
    batch = _batch(cfg, 2, 48, seed=4)
    want_logits, want_cache = jax.jit(
        jax_build_model(jcfg, attn_impl=jax_impl).prefill)(_jt(np_params),
                                                           _jt(batch))
    model = build_model(cfg)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    logits, cache = make_prefill_step(model)(params, _tt(batch))
    assert _rel(logits, want_logits) <= DECODE_RTOL
    for path, leaf in named_leaves(jax.tree_util.tree_map(np.asarray,
                                                          want_cache)):
        assert _rel(dict(named_leaves(cache))[path], leaf) <= RTOL, path
