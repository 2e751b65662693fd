"""The port's decode path and server against the JAX package's, on the CPU.

Weights are drawn once in JAX, passed through numpy and carried into the port
by path, so both packages decode with the same parameters.  Decode logits may
differ only by summation order: max|Δ|/max|logit| ≤ 1e-4 in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce_for_smoke
from repro.launch.serve import Server as JaxServer
from repro.launch.serve import ServeJob as JaxServeJob
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.serve import Server, ServeJob
from repro_torch.models import build_model, from_numpy_tree

DECODE_RTOL = 1e-4


def _numpy_params(jmodel, seed):
    """JAX-initialised weights as numpy; constant leaves (norm scales, qkv
    biases) get noise so that the comparison sees them."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(a):
        if a.size > 1 and np.all(a == a.flat[0]):
            noise = 0.1 * rng.standard_normal(a.shape)
            return (a.astype(np.float32) + noise).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(perturb, tree)


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks else (B, S)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _jax_logits(jmodel, np_params, tokens, steps):
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    cache = jmodel.init_cache(tokens.shape[0], steps)
    step = jax.jit(jmodel.decode_step)
    out = []
    for t in range(steps):
        logits, cache = step(params, cache, jnp.asarray(tokens[..., t]),
                             jnp.int32(t))
        out.append(np.asarray(logits))
    return np.stack(out)


def _torch_logits(model, params, tokens, steps):
    cache = model.init_cache(tokens.shape[0], steps, "cpu")
    head = model.logits_weight(params)
    out = []
    for t in range(steps):
        tok = torch.from_numpy(np.ascontiguousarray(tokens[..., t])).long()
        logits, cache = model.decode_step(params, cache, tok, t, head=head)
        out.append(logits.numpy())
    return np.stack(out)


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


# gemma-2b: MQA; starcoder2-3b: window 64 and qkv bias, run past 64 steps so
# the ring buffer wraps; gemma3-27b: L/G periods plus a tail layer, also
# wrapping; musicgen-medium: summed codebook embeddings and K heads.
DECODE_ARCHS = [("gemma-2b", 16), ("starcoder2-3b", 72), ("gemma3-27b", 72),
                ("musicgen-medium", 16)]


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("arch,steps", DECODE_ARCHS)
def test_decode_logits_match_jax(arch, steps, jax_impl):
    jcfg = jax_reduce_for_smoke(jax_get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build_model(jcfg, attn_impl=jax_impl)
    np_params = _numpy_params(jmodel, seed=1)
    tokens = _tokens(cfg, B=2, S=steps, seed=2)
    want = _jax_logits(jmodel, np_params, tokens, steps)
    for impl in ("kernel", "torch"):
        model = build_model(cfg, attn_impl=impl)
        params = from_numpy_tree(np_params, "cpu", model.param_specs())
        got = _torch_logits(model, params, tokens, steps)
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        err = _rel_err(got, want)
        assert err <= DECODE_RTOL, (arch, jax_impl, impl, err)


@pytest.fixture(scope="module")
def full_width_gemma():
    """gemma-2b at full width (d=2048, 8 heads, MQA, head_dim 256, d_ff 16384)
    cut to one layer and a 512-entry vocab, in fp32."""
    cut = dict(num_layers=1, vocab_size=512, dtype="float32")
    jcfg = jax_get_arch("gemma-2b").with_(**cut)
    cfg = get_arch("gemma-2b").with_(**cut)
    np_params = _numpy_params(jax_build_model(jcfg), seed=3)
    return jcfg, cfg, np_params


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_full_width_gemma_decode_matches_jax(full_width_gemma, jax_impl):
    jcfg, cfg, np_params = full_width_gemma
    steps = 6
    tokens = _tokens(cfg, B=2, S=steps, seed=4)
    want = _jax_logits(jax_build_model(jcfg, attn_impl=jax_impl), np_params,
                       tokens, steps)
    model = build_model(cfg)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    got = _torch_logits(model, params, tokens, steps)
    err = _rel_err(got, want)
    assert err <= DECODE_RTOL, (jax_impl, err)


def test_greedy_generation_matches_jax_server():
    kw = dict(arch="gemma-2b", batch=2, prompt_len=8, max_new_tokens=6)
    jsrv = JaxServer(JaxServeJob(**kw))
    prompts = np.random.default_rng(0).integers(
        0, jsrv.cfg.vocab_size, (2, 8)).astype(np.int32)
    want = jsrv.generate(prompts)
    np_params = jax.tree_util.tree_map(np.asarray, jsrv.params)
    srv = Server(ServeJob(**kw), params=from_numpy_tree(np_params, "cpu"),
                 device="cpu")
    got = srv.generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert srv.stats["tokens"] == 2 * 6
    assert srv.throughput() > 0


def test_server_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ServeJob())


def test_temperature_sampling_is_seeded_and_in_vocab():
    job = ServeJob(arch="gemma-2b", batch=2, prompt_len=4, max_new_tokens=5,
                   temperature=0.8, seed=7)
    srv = Server(job, device="cpu")
    prompts = np.zeros((2, 4), np.int32)
    out = srv.generate(prompts)
    assert out.shape == (2, 9)
    assert (out[:, 4:] < srv.cfg.vocab_size).all()
    np.testing.assert_array_equal(out, Server(job, device="cpu").generate(prompts))


def test_model_axis_and_unported_families_raise():
    with pytest.raises(NotImplementedError, match="distribution"):
        Server(ServeJob(model_axis=2), device="cpu")
    assert build_model(get_arch("granite-moe-1b-a400m")).cfg.family == "moe"
    with pytest.raises(NotImplementedError, match="item 12"):
        build_model(get_arch("deepseek-v3-671b"))
