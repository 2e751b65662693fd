#!/usr/bin/env python3
"""How far bf16 rounding carries mamba2's, zamba2's and granite's decode
logits away from other paths to the same logits, in the JAX package and in
its PyTorch port, at the full widths with the depth cut.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ssm_bf16_drift.py \\
        --arch mamba2-1.3b --layers 6 12 24

For each depth: the architecture's widths with ``num_layers`` cut to it
(zamba2's by whole periods of its shared block; granite-moe-1b-a400m's at
its configured capacity factor of 1.25, so that its decode and forward also
differ by the assignments the forward's 64 tokens drop), weights drawn in
JAX from seed 0 (bf16, as configured) and carried into the port by path,
and one sequence of 64 random tokens.  In fp32 (the weights cast up) and in bf16, the
logits of every position through

- the decode step and the train forward, for JAX's ``xla`` and
  ``pallas_interpret`` impls and the port's plain ``torch`` impl (on the
  CPU the port's kernel wrappers run the same plain code);

and it prints, as the largest difference over the vocabulary's real slots
relative to the largest logit of the second (``tests/test_models.py``'s
measure), the worst position of: each impl's decode against its forward;
JAX's ``pallas_interpret`` decode and forward against its ``xla``; and the
port's against JAX's ``xla``.  One JSON line per depth.  It runs on the CPU
and needs a few GB of memory per 12 layers.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.models import build_model, from_numpy_tree
from repro_torch.models.layers import rmsnorm

JAX_IMPLS = ("xla", "pallas_interpret")
STEPS = 64          # positions decoded
SEED = 0


def _jax_logits(model, params, tokens):
    """Forward and decode logits, (S, V) each, of one sequence."""
    S = tokens.shape[1]
    positions = jnp.arange(S, dtype=jnp.int32)[None]

    @jax.jit
    def forward(params, tokens):
        h = model._embed_tokens(params, {"tokens": tokens})
        h, _ = model.backbone(params, h, positions)
        h = jax_rmsnorm(params["final_ln"], h, model.cfg.norm_eps)
        return model._logits(params, h)[0]

    fwd = np.asarray(forward(params, jnp.asarray(tokens)))
    step = jax.jit(model.decode_step)
    cache = model.init_cache(1, S)
    dec = []
    for t in range(S):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t]),
                             jnp.int32(t))
        dec.append(np.asarray(logits)[0])
    return fwd, np.stack(dec)


def _torch_logits(model, params, tokens):
    S = tokens.shape[1]
    tok = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        head = model.logits_weight(params)
        h = model._embed_tokens(params, {"tokens": tok})
        h = model.backbone(params, h, torch.arange(S)[None])
        fwd = model._logits(params, rmsnorm(params["final_ln"], h,
                                            model.cfg.norm_eps), head)[0]
        cache = model.init_cache(1, S, "cpu")
        dec = []
        for t in range(S):
            logits, cache = model.decode_step(params, cache, tok[:, t], t,
                                              head=head)
            dec.append(logits[0])
    return fwd.float().numpy(), torch.stack(dec).float().numpy()


def _worst(got, want, V):
    """The worst position's largest difference relative to its largest
    logit, and that position."""
    got, want = got[:, :V], want[:, :V]
    rel = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    return {"max": float(rel.max()), "at": int(rel.argmax())}


def measure(arch: str, layers: int) -> dict:
    jcfg = jax_get_arch(arch).with_(num_layers=layers)
    cfg = get_arch(arch).with_(num_layers=layers)
    V = cfg.vocab_size
    bf16 = jax_build_model(jcfg).init(jax.random.PRNGKey(SEED))
    bf16 = jax.tree_util.tree_map(np.asarray, bf16)
    tokens = np.random.default_rng(SEED + 1).integers(
        0, V, (1, STEPS)).astype(np.int32)
    out = {"arch": arch, "layers": layers, "d_model": cfg.d_model,
           "steps": STEPS, "seed": SEED}
    for dtype in ("float32", "bfloat16"):
        np_params = bf16 if dtype == "bfloat16" else jax.tree_util.tree_map(
            lambda a: a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16
            else a, bf16)
        jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
        logits = {}
        for impl in JAX_IMPLS:
            logits[impl] = _jax_logits(
                jax_build_model(jcfg.with_(dtype=dtype), attn_impl=impl),
                jparams, tokens)
        del jparams
        model = build_model(cfg.with_(dtype=dtype), attn_impl="torch")
        logits["port"] = _torch_logits(
            model, from_numpy_tree(np_params, "cpu", model.param_specs()),
            tokens)
        out[dtype] = {
            "decode_vs_forward": {k: _worst(d, f, V)
                                  for k, (f, d) in logits.items()},
            "pallas_interpret_vs_xla": {
                "forward": _worst(logits["pallas_interpret"][0],
                                  logits["xla"][0], V),
                "decode": _worst(logits["pallas_interpret"][1],
                                 logits["xla"][1], V)},
            "port_vs_xla": {
                "forward": _worst(logits["port"][0], logits["xla"][0], V),
                "decode": _worst(logits["port"][1], logits["xla"][1], V)},
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b",
                    choices=["mamba2-1.3b", "zamba2-2.7b",
                             "granite-moe-1b-a400m"])
    ap.add_argument("--layers", type=int, nargs="+", default=[6, 12, 24])
    args = ap.parse_args()
    for layers in args.layers:
        t0 = time.perf_counter()
        out = measure(args.arch, layers)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
