"""The port's configs and parameter trees against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduce_for_smoke as jax_reduce_for_smoke
from repro.models import count_params as jax_count_params
from repro.models import param_bytes as jax_param_bytes
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.models import (ParamSpec, abstract, build_model, count_params,
                                from_numpy_tree, materialize, named_leaves,
                                param_bytes)

PORTED_ARCHS = ["starcoder2-3b", "qwen2-72b", "gemma-2b", "gemma3-27b",
                "musicgen-medium", "phi-3-vision-4.2b", "mamba2-1.3b",
                "zamba2-2.7b"]


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_are_the_jax_configs(arch):
    assert dataclasses.asdict(ARCHS[arch]) == dataclasses.asdict(JAX_ARCHS[arch])
    assert dataclasses.asdict(reduce_for_smoke(ARCHS[arch])) == \
        dataclasses.asdict(jax_reduce_for_smoke(JAX_ARCHS[arch]))


def _jax_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: not isinstance(x, dict))
    return {"/".join(k.key for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_full_size_spec_tree_matches_jax(arch):
    jspecs = jax_build_model(JAX_ARCHS[arch]).param_specs()
    specs = build_model(ARCHS[arch]).param_specs()
    want = _jax_leaves(jspecs)
    got = dict(named_leaves(specs))
    assert list(got) == list(want)      # same paths, in JAX's flattening order
    for path, s in got.items():
        w = want[path]
        assert (s.shape, s.axes, s.init, s.scale, s.dtype, s.fan_in) == \
            (w.shape, w.axes, w.init, w.scale, w.dtype, w.fan_in), path
    # the meta device: full size, nothing allocated
    for path, t in named_leaves(abstract(specs)):
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[path].shape
        assert t.dtype == getattr(torch, want[path].dtype), path
    assert count_params(specs) == jax_count_params(jspecs)
    assert param_bytes(specs) == jax_param_bytes(jspecs)
    assert ARCHS[arch].param_count_estimate() == count_params(specs)


def test_materialize_covers_every_init_kind():
    specs = {
        "w": ParamSpec((256, 512), (None, None), scale=2.0, dtype="float32"),
        "e": ParamSpec((4, 1024, 64), (None, None, None), fan_in=64,
                       dtype="bfloat16"),
        "z": ParamSpec((8,), (None,), init="zeros"),
        "o": ParamSpec((8,), (None,), init="ones", dtype="float32"),
        "a": ParamSpec((4096,), (None,), init="ssm_a"),
        "dt": ParamSpec((4096,), (None,), init="ssm_dt"),
    }
    p = materialize(specs, torch.Generator().manual_seed(0), "cpu")
    assert p["w"].dtype == torch.float32 and p["e"].dtype == torch.bfloat16
    assert abs(p["w"].std().item() - 2.0 / np.sqrt(256)) < 0.01
    assert abs(p["e"].float().std().item() - 1.0 / np.sqrt(64)) < 0.005
    assert (p["z"] == 0).all() and p["z"].dtype == torch.bfloat16
    assert (p["o"] == 1).all()
    # ssm inits are kept in fp32 whatever the spec says
    a = torch.exp(p["a"])
    assert p["a"].dtype == torch.float32 and a.min() >= 1 and a.max() <= 16
    dt = torch.log1p(torch.exp(p["dt"]))    # softplus undoes log(expm1(u))
    assert dt.min() >= 1e-3 - 1e-6 and dt.max() <= 1e-1 + 1e-6
    again = materialize(specs, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    over = materialize(specs, torch.Generator().manual_seed(0), "cpu",
                       dtype_override="float32")
    assert over["e"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_numpy_tree_round_trips(dtype):
    cfg = reduce_for_smoke(ARCHS["gemma3-27b"]).with_(dtype=dtype)
    jmodel = jax_build_model(jax_reduce_for_smoke(JAX_ARCHS["gemma3-27b"])
                             .with_(dtype=dtype))
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    specs = build_model(cfg).param_specs()
    params = from_numpy_tree(tree, "cpu", specs)
    for path, a in _jax_leaves(tree).items():
        t = dict(named_leaves(params))[path]
        assert t.dtype == getattr(torch, a.dtype.name), path
        if a.dtype == ml_dtypes.bfloat16:
            back = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            back = t.numpy()
        np.testing.assert_array_equal(back, a, err_msg=path)
    # the carried-over arrays are copies: the port's tensors do not alias JAX's
    leaf = params["final_ln"]
    leaf += 1
    assert not np.array_equal(leaf.numpy(), tree["final_ln"])


def test_from_numpy_tree_checks_paths_shapes_and_dtypes():
    specs = build_model(reduce_for_smoke(ARCHS["gemma-2b"])).param_specs()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jax_reduce_for_smoke(JAX_ARCHS["gemma-2b"]))
        .init(jax.random.PRNGKey(0)))
    from_numpy_tree(tree, "cpu", specs)
    missing = dict(tree)
    del missing["final_ln"]
    with pytest.raises(ValueError, match="missing"):
        from_numpy_tree(missing, "cpu", specs)
    wrong = dict(tree, final_ln=tree["final_ln"][:-1])
    with pytest.raises(ValueError, match="final_ln"):
        from_numpy_tree(wrong, "cpu", specs)
    wrong = dict(tree, final_ln=np.asarray(jnp.asarray(tree["final_ln"],
                                                       jnp.bfloat16)))
    with pytest.raises(ValueError, match="final_ln"):
        from_numpy_tree(wrong, "cpu", specs)
