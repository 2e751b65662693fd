"""Model assembly for decode (PyTorch port of ``repro.models.model``).

This slice carries the dense, audio and vlm families (starcoder2, qwen2,
gemma, gemma3, musicgen, phi3v backbones) through ``decode_step``.  The other
families raise ``NotImplementedError`` naming the ROADMAP item that ports them.

Parameters are a nested dict of tensors with the JAX package's paths
(``blocks/attn/wq``), stacked with a leading layer axis as there; a Python
loop over the layer index takes the place of ``lax.scan``.

API:
    m = build_model(cfg)
    specs  = m.param_specs()                        # ParamSpec tree
    params = m.init(generator, device)              # real tensors
    cache  = m.init_cache(batch, max_len, device)
    head   = m.logits_weight(params)                # fp32, once per params
    logits, cache = m.decode_step(params, cache, tokens, pos, head=head)
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import attention as attn
from .layers import embed, mlp, mlp_specs, rmsnorm
from .param import ParamSpec, materialize

_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 9 (MoE family)",
    "ssm": "ROADMAP Queue 1 item 11 (SSM and hybrid)",
    "hybrid": "ROADMAP Queue 1 item 11 (SSM and hybrid)",
}


def _ln(d: int, stack: Tuple[int, ...] = ()) -> ParamSpec:
    return ParamSpec(stack + (d,), (None,) * len(stack) + (None,), init="ones",
                     dtype="float32")


def _index(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views, no copy)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class Model:
    def __init__(self, cfg: ModelConfig, attn_impl: str = "kernel") -> None:
        if cfg.family in _NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; see "
                f"{_NOT_PORTED[cfg.family]}")
        if cfg.family not in ("dense", "audio", "vlm"):
            raise ValueError(cfg.family)
        if cfg.attention != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.attention} attention is not ported yet; see "
                "ROADMAP Queue 1 item 12 (MLA and MTP)")
        self.cfg = cfg
        self.attn_impl = attn_impl

    # ------------------------------------------------------------ param specs
    def _dense_block_specs(self, stack):
        cfg = self.cfg
        return {
            "ln1": _ln(cfg.d_model, stack),
            "attn": attn.gqa_specs(cfg, stack),
            "ln2": _ln(cfg.d_model, stack),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.dtype, stack),
        }

    def param_specs(self):
        cfg = self.cfg
        specs: Dict[str, Any] = {}
        V = cfg.padded_vocab   # padded so the vocab axis always TP-shards
        if cfg.num_codebooks:          # musicgen: K codebook embeddings + heads
            specs["embed"] = ParamSpec((cfg.num_codebooks, V, cfg.d_model),
                                       (None, "vocab", "fsdp"),
                                       dtype=cfg.dtype, fan_in=cfg.d_model)
            specs["head"] = ParamSpec((cfg.d_model, cfg.num_codebooks, V),
                                      ("fsdp", None, "vocab"),
                                      dtype=cfg.dtype, fan_in=cfg.d_model)
        else:
            specs["embed"] = ParamSpec((V, cfg.d_model),
                                       ("vocab", "fsdp"), dtype=cfg.dtype,
                                       fan_in=cfg.d_model)
            if not cfg.tie_embeddings:
                specs["head"] = ParamSpec((cfg.d_model, V),
                                          ("fsdp", "vocab"), dtype=cfg.dtype)
        if cfg.num_image_tokens:       # phi3v: projector from frontend stub
            specs["img_proj"] = ParamSpec((1024, cfg.d_model), (None, "fsdp"),
                                          dtype=cfg.dtype)
        specs["final_ln"] = _ln(cfg.d_model)
        if cfg.local_global_pattern:
            P = len(cfg.local_global_pattern)
            n_per, n_tail = divmod(cfg.num_layers, P)
            specs["periods"] = self._dense_block_specs((n_per, P))
            if n_tail:
                specs["tail"] = self._dense_block_specs((n_tail,))
        else:
            specs["blocks"] = self._dense_block_specs((cfg.num_layers,))
        return specs

    def init(self, generator: torch.Generator, device,
             dtype_override: Optional[str] = None):
        return materialize(self.param_specs(), generator, device,
                           dtype_override)

    # ---------------------------------------------------------------- caches
    def cache_specs(self, batch: int, max_len: int):
        """ParamSpec tree describing the decode cache."""
        cfg = self.cfg
        seq_ax = "seq" if cfg.seq_shard_attn else None

        def kv(n_layers_stack, T):
            shape = tuple(n_layers_stack) + (batch, T, cfg.num_kv_heads,
                                             cfg.head_dim)
            axes = (None,) * len(n_layers_stack) + ("batch", seq_ax, "heads",
                                                    None)
            return {"k": ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype),
                    "v": ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype)}

        W = min(cfg.sliding_window or max_len, max_len)
        if cfg.local_global_pattern:
            pat = cfg.local_global_pattern
            n_per, n_tail = divmod(cfg.num_layers, len(pat))
            nL = sum(1 for k in pat if k == "L")
            out = {"periods_local": kv((n_per, nL), W),
                   "periods_global": kv((n_per, len(pat) - nL), max_len)}
            if n_tail:
                out["tail"] = kv((n_tail,), W if pat[0] == "L" else max_len)
            return out
        T = W if cfg.sliding_window else max_len
        return {"layers": kv((cfg.num_layers,), T)}

    def init_cache(self, batch: int, max_len: int, device):
        # every cache leaf is zeros, so no generator is drawn from
        return materialize(self.cache_specs(batch, max_len), None, device)

    # ---------------------------------------------------------------- logits
    def logits_weight(self, params) -> torch.Tensor:
        """The output projection in fp32, as ``_logits`` multiplies by it.

        At full width it is large (gemma-2b's tied table: 2.1 GB in fp32), so a
        caller that decodes many steps makes it once and passes it to every
        ``decode_step``.
        """
        cfg = self.cfg
        if cfg.tie_embeddings and not cfg.num_codebooks:
            return params["embed"].float()      # (V, d), used transposed
        return params["head"].float()           # (d, V) or (d, K, V)

    def _logits(self, params, h, head: Optional[torch.Tensor] = None):
        cfg = self.cfg
        w = self.logits_weight(params) if head is None else head
        hf = h.float()
        if cfg.num_codebooks:
            logits = torch.einsum("bsd,dkv->bskv", hf, w)
        elif cfg.tie_embeddings:
            logits = hf @ w.T
        else:
            logits = hf @ w
        if cfg.padded_vocab != cfg.vocab_size:  # mask pad slots out of softmax
            pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits

    # ------------------------------------------------------------------ decode
    def _dense_step(self, p, h, ck, cv, pos: int, kind: str):
        cfg = self.cfg
        window = cfg.sliding_window if kind == "L" else 0
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        a, ck, cv = attn.gqa_decode(p["attn"], hn, ck, cv, pos, cfg,
                                    window=window, impl=self.attn_impl)
        h = h + a
        hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
        return h + mlp(p["mlp"], hn, cfg.mlp)

    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int, *,
                    head: Optional[torch.Tensor] = None):
        """One token for the whole batch. tokens (B,) or (B,K) int64; pos a
        host int.  Returns (logits, cache); the cache is updated in place.

        ``head`` is ``logits_weight(params)``, made once by a caller that
        decodes many steps.
        """
        cfg = self.cfg
        if cfg.num_codebooks:
            h = None
            for k in range(cfg.num_codebooks):
                e = embed(params["embed"][k], tokens[:, k][:, None])
                h = e if h is None else h + e
        else:
            h = embed(params["embed"], tokens[:, None])     # (B,1,d)
        # the scale is rounded to h's dtype before the product, as in JAX
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)

        if cfg.local_global_pattern:
            h = self._decode_pattern(params, cache, h, pos)
        else:
            kind = "L" if cfg.sliding_window else "G"
            layers = cache["layers"]
            for i in range(cfg.num_layers):
                h = self._dense_step(_index(params["blocks"], i), h,
                                     layers["k"][i], layers["v"][i], pos, kind)
        h = rmsnorm(params["final_ln"], h, cfg.norm_eps)
        logits = self._logits(params, h, head)[:, 0]
        return logits, cache

    def _decode_pattern(self, params, cache, h, pos: int):
        pat = self.cfg.local_global_pattern
        local, glob = cache["periods_local"], cache["periods_global"]
        for n in range(params["periods"]["ln1"].shape[0]):
            li = gi = 0
            for i, kind in enumerate(pat):
                p = _index(_index(params["periods"], n), i)
                if kind == "L":
                    ck, cv = local["k"][n, li], local["v"][n, li]
                    li += 1
                else:
                    ck, cv = glob["k"][n, gi], glob["v"][n, gi]
                    gi += 1
                h = self._dense_step(p, h, ck, cv, pos, kind)
        if "tail" in params:
            tail = cache["tail"]
            for i in range(params["tail"]["ln1"].shape[0]):
                h = self._dense_step(_index(params["tail"], i), h,
                                     tail["k"][i], tail["v"][i], pos, pat[0])
        return h


def build_model(cfg: ModelConfig, attn_impl: str = "kernel") -> Model:
    return Model(cfg, attn_impl=attn_impl)
