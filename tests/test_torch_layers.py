"""The port's layers against the JAX package's, in fp32, at atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.param import materialize as jax_materialize
from repro_torch.models import layers as tl
from repro_torch.models.param import from_numpy_tree

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("shape", [(2, 3, 64), (1, 5, 7, 256)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jl.rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6)
    got = tl.rmsnorm(_t(scale), _t(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("D,theta", [(32, 10_000.0), (256, 10_000.0),
                                     (128, 1_000_000.0)])
def test_apply_rope_matches_jax(D, theta):
    rng = np.random.default_rng(1)
    B, S, H = 2, 9, 3
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    positions = rng.integers(0, 4096, (B, S)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = tl.apply_rope(_t(x), torch.from_numpy(positions), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tl.rope_frequencies(D, theta).numpy(),
                               np.asarray(jl.rope_frequencies(D, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("variant", ["silu_glu", "gelu_glu", "gelu"])
def test_mlp_matches_jax(variant):
    import jax
    d, f = 64, 96
    jspecs = jl.mlp_specs(d, f, variant, "float32")
    tspecs = tl.mlp_specs(d, f, variant, "float32")
    assert {k: (s.shape, s.axes, s.dtype) for k, s in jspecs.items()} == \
        {k: (s.shape, s.axes, s.dtype) for k, s in tspecs.items()}
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_materialize(jspecs, jax.random.PRNGKey(0)))
    x = np.random.default_rng(2).standard_normal((2, 3, d)).astype(np.float32)
    want = jl.mlp(jax.tree_util.tree_map(jnp.asarray, np_params),
                  jnp.asarray(x), variant)
    got = tl.mlp(from_numpy_tree(np_params, "cpu", tspecs), _t(x), variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_embed_matches_jax():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    tokens = rng.integers(0, 50, (2, 7))
    want = jl.embed(jnp.asarray(table), jnp.asarray(tokens))
    got = tl.embed(_t(table), torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
