"""Model assembly for training and decode (PyTorch port of
``repro.models.model``).

Carried through ``loss_fn`` and ``decode_step``:

    dense   - starcoder2 / qwen2 / gemma / gemma3 / musicgen / phi3v backbones
              (with the audio and vlm families)
    moe     - granite (GQA + 32 routed experts); with GQA attention, also
              the sigmoid router, shared experts and leading dense layers
              of deepseek-v3
    ssm     - mamba2 (attention-free SSD, through the ssd-scan kernel)
    hybrid  - zamba2 (mamba2 backbone + one SHARED GQA block every N layers)

MLA attention (deepseek-v3's) raises ``NotImplementedError`` naming the
ROADMAP item that ports it.  The moe family's ``loss_fn`` adds 0.01 times
the load-balance loss summed over the MoE layers, as JAX's does, and
reports it as ``metrics["aux"]``.

Parameters are a nested dict of tensors with the JAX package's paths
(``blocks/attn/wq``), stacked with a leading layer axis as there; a Python
loop over the layer index (or the period, for local/global patterns and
zamba2) takes the place of ``lax.scan``, with ``maybe_remat`` around each
iteration as JAX puts it around the scan body.  zamba2's shared attention
block is closed over, not stacked, so its gradient sums over every
invocation.

API:
    m = build_model(cfg)
    specs  = m.param_specs()                        # ParamSpec tree
    params = m.init(generator, device)              # real tensors
    loss, metrics = m.loss_fn(params, batch)        # train forward
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
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (embed, maybe_remat, mlp, mlp_specs, rmsnorm,
                     softmax_cross_entropy)
from .param import ParamSpec, materialize


def _ln(d: int, stack: Tuple[int, ...] = ()) -> ParamSpec:
    return ParamSpec(stack + (d,), (None,) * len(stack) + (None,), init="ones",
                     dtype="float32")


def _index(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views, no copy)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree):
    """A stacked tree as the list of its layers (views, no copy).

    One ``unbind`` per leaf, so the backward stacks the layers' gradients
    once; indexing layer by layer would zero-fill and add a full-size
    gradient for every layer.
    """
    parts = {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


class Model:
    def __init__(self, cfg: ModelConfig, attn_impl: str = "kernel") -> None:
        if cfg.family not in ("dense", "audio", "vlm", "moe", "ssm", "hybrid"):
            raise ValueError(cfg.family)
        if cfg.family != "ssm" and cfg.attention != "gqa" or cfg.mtp_depth:
            what = (f"{cfg.attention} attention" if cfg.attention != "gqa"
                    else "multi-token prediction")
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; see ROADMAP Queue 1 "
                "item 12 (MLA and MTP)")
        self.cfg = cfg
        self.attn_impl = attn_impl
        if cfg.family == "hybrid":      # zamba2's shared attention block
            hb = cfg.hybrid
            self.shared_cfg = cfg.with_(
                num_heads=hb.shared_attn_heads,
                num_kv_heads=hb.shared_attn_kv_heads,
                head_dim=cfg.d_model // hb.shared_attn_heads)

    # ------------------------------------------------------------ param specs
    def _dense_block_specs(self, stack):
        cfg = self.cfg
        return {
            "ln1": _ln(cfg.d_model, stack),
            "attn": attn.gqa_specs(cfg, stack),
            "ln2": _ln(cfg.d_model, stack),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.dtype, stack),
        }

    def _moe_block_specs(self, stack):
        cfg = self.cfg
        return {
            "ln1": _ln(cfg.d_model, stack),
            "attn": attn.gqa_specs(cfg, stack),
            "ln2": _ln(cfg.d_model, stack),
            "moe": moe_lib.moe_specs(cfg, stack),
        }

    def _ssm_block_specs(self, stack):
        return {"ln": _ln(self.cfg.d_model, stack),
                "ssm": ssm_lib.ssm_specs(self.cfg, stack)}

    def _shared_attn_specs(self):
        """zamba2 shared block: GQA + (optional) MLP, UNSTACKED."""
        cfg = self.cfg
        specs = {"ln1": _ln(cfg.d_model),
                 "attn": attn.gqa_specs(self.shared_cfg)}
        if cfg.hybrid.shared_attn_d_ff:
            specs["ln2"] = _ln(cfg.d_model)
            specs["mlp"] = mlp_specs(cfg.d_model, cfg.hybrid.shared_attn_d_ff,
                                     cfg.mlp, cfg.dtype)
        return specs

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
        if cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            if nd:
                specs["dense_blocks"] = self._dense_block_specs((nd,))
            specs["moe_blocks"] = self._moe_block_specs((cfg.num_layers - nd,))
        elif cfg.family == "ssm":
            specs["blocks"] = self._ssm_block_specs((cfg.num_layers,))
        elif cfg.family == "hybrid":
            P = cfg.hybrid.shared_attn_period
            specs["shared_attn"] = self._shared_attn_specs()
            specs["mamba"] = self._ssm_block_specs((cfg.num_layers // P, P))
        elif cfg.local_global_pattern:
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

    # ------------------------------------------------------------- block fwd
    def _dense_block(self, p, h, positions, kind: str, aux=None):
        """-> (h, aux): a layer with ``"moe"`` adds its load-balance loss to
        ``aux``; any other passes ``aux`` through."""
        cfg = self.cfg
        window = cfg.sliding_window if kind == "L" else 0
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        h = h + attn.gqa_train(p["attn"], hn, positions, cfg, window=window,
                               impl=self.attn_impl)
        hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
        if "moe" in p:
            out, aux_i = moe_lib.moe_apply(p["moe"], hn, cfg)
            aux = aux + aux_i
        else:
            out = mlp(p["mlp"], hn, cfg.mlp)
        return h + out, aux

    def _ssm_block(self, p, h):
        hn = rmsnorm(p["ln"], h, self.cfg.norm_eps)
        return h + ssm_lib.mamba2_forward(p["ssm"], hn, self.cfg,
                                          impl=self.attn_impl)

    def _shared_attn_block(self, p, h, positions):
        cfg = self.cfg
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        h = h + attn.gqa_train(p["attn"], hn, positions, self.shared_cfg,
                               impl=self.attn_impl)
        if "mlp" in p:
            hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
            h = h + mlp(p["mlp"], hn, cfg.mlp)
        return h

    # --------------------------------------------------------------- embed
    def _scale_embeddings(self, h):
        # the scale is rounded to h's dtype before the product, as in JAX
        return h * torch.tensor(math.sqrt(self.cfg.d_model), dtype=h.dtype,
                                device=h.device)

    def _embed_tokens(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"].long()
        if cfg.num_codebooks:                           # (B, K, S)
            h = None
            for k in range(cfg.num_codebooks):
                e = embed(params["embed"][k], tokens[:, k])
                h = e if h is None else h + e
        else:
            h = embed(params["embed"], tokens)          # (B, S, d)
        h = self._scale_embeddings(h)
        if cfg.num_image_tokens and "image_embeds" in batch:
            img = batch["image_embeds"].to(h.dtype) @ params["img_proj"]
            h = torch.cat([img, h[:, cfg.num_image_tokens:]], dim=1)
        return h

    # -------------------------------------------------------------- backbone
    def backbone(self, params, h, positions):
        """Token embeddings -> final hidden states."""
        cfg = self.cfg
        if cfg.family == "moe":
            return self._moe_backbone(params, h, positions)[0]
        if cfg.family == "ssm":
            body = maybe_remat(lambda hh, p: self._ssm_block(p, hh), cfg.remat)
            for p in _unbind(params["blocks"]):
                h = body(h, p)
            return h
        if cfg.family == "hybrid":
            shared = params["shared_attn"]

            def period(hh, p):
                hh = self._shared_attn_block(shared, hh, positions)
                for layer in _unbind(p):
                    hh = self._ssm_block(layer, hh)
                return hh

            body = maybe_remat(period, cfg.remat)
            for p in _unbind(params["mamba"]):
                h = body(h, p)
            return h
        if cfg.local_global_pattern:
            pat = cfg.local_global_pattern

            def period_body(hh, p):
                for layer, kind in zip(_unbind(p), pat):
                    hh = self._dense_block(layer, hh, positions, kind)[0]
                return hh

            body = maybe_remat(period_body, cfg.remat)
            for p in _unbind(params["periods"]):
                h = body(h, p)
            if "tail" in params:
                tail_body = maybe_remat(
                    lambda hh, p: self._dense_block(p, hh, positions,
                                                    pat[0])[0],
                    cfg.remat)
                for p in _unbind(params["tail"]):
                    h = tail_body(h, p)
            return h
        kind = "L" if cfg.sliding_window else "G"
        body = maybe_remat(
            lambda hh, p: self._dense_block(p, hh, positions, kind)[0],
            cfg.remat)
        for p in _unbind(params["blocks"]):
            h = body(h, p)
        return h

    def _moe_backbone(self, params, h, positions):
        """The moe family's layers: the leading dense ones, then the MoE
        ones, each under ``maybe_remat``.  -> (h, aux summed over layers)."""
        body = maybe_remat(
            lambda hh, aux, p: self._dense_block(p, hh, positions, "G", aux),
            self.cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for name in ("dense_blocks", "moe_blocks"):
            for p in (_unbind(params[name]) if name in params else ()):
                h, aux = body(h, aux, p)
        return h, aux

    # ------------------------------------------------------------------ train
    def loss_fn(self, params, batch):
        """batch: tokens and targets (B,S) or (B,K,S) int, loss_mask (B,S)
        [, image_embeds] -> (loss, {"ce", "loss"})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[-1]
        B = tokens.shape[0]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        h = self._embed_tokens(params, batch)
        if cfg.family == "moe":
            h, aux = self._moe_backbone(params, h, positions)
        else:
            h = self.backbone(params, h, positions)
        h = rmsnorm(params["final_ln"], h, cfg.norm_eps)
        logits = self._logits(params, h)
        targets = batch["targets"]
        mask = batch.get("loss_mask")
        if cfg.num_codebooks:       # (B,S,K,V) vs targets (B,K,S)
            t = targets.movedim(1, 2)
            m = mask[..., None].expand(t.shape) if mask is not None else None
            ce = softmax_cross_entropy(logits, t, m)
        else:
            ce = softmax_cross_entropy(logits, targets, mask)
        if cfg.family != "moe":
            return ce, {"ce": ce, "loss": ce}
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    # ---------------------------------------------------------------- caches
    def cache_specs(self, batch: int, max_len: int):
        """ParamSpec tree describing the decode cache."""
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):
            return self._ssm_cache_specs(batch, max_len)
        seq_ax = "seq" if cfg.seq_shard_attn else None

        def kv(n_layers_stack, T):
            shape = tuple(n_layers_stack) + (batch, T, cfg.num_kv_heads,
                                             cfg.head_dim)
            axes = (None,) * len(n_layers_stack) + ("batch", seq_ax, "heads",
                                                    None)
            return {"k": ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype),
                    "v": ParamSpec(shape, axes, init="zeros", dtype=cfg.dtype)}

        if cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            out = {"moe_layers": kv((cfg.num_layers - nd,), max_len)}
            if nd:
                out["dense_layers"] = kv((nd,), max_len)
            return out
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

    def _ssm_cache_specs(self, batch: int, max_len: int):
        """The fp32 SSM state (..., B, nh, N, P) and the conv cache
        (..., B, K-1, conv_dim) per mamba layer; for zamba2 also the shared
        block's K/V cache per invocation."""
        cfg = self.cfg
        s = cfg.ssm
        conv_dim = cfg.expand_dim + 2 * s.n_groups * s.d_state
        if cfg.family == "ssm":
            stack = (cfg.num_layers,)
        else:
            P = cfg.hybrid.shared_attn_period
            stack = (cfg.num_layers // P, P)
        ax = (None,) * len(stack)
        out = {
            "state": ParamSpec(stack + (batch, cfg.ssm_heads, s.d_state,
                                        s.head_dim),
                               ax + ("batch", "heads", None, None),
                               init="zeros", dtype="float32"),
            "conv": ParamSpec(stack + (batch, s.conv_kernel - 1, conv_dim),
                              ax + ("batch", None, "model"), init="zeros",
                              dtype=cfg.dtype),
        }
        if cfg.family == "hybrid":
            sub = self.shared_cfg
            seq_ax = "seq" if cfg.seq_shard_attn else None
            shape = (stack[0], batch, max_len, sub.num_kv_heads, sub.head_dim)
            axes = (None, "batch", seq_ax, "heads", None)
            out["attn_k"] = ParamSpec(shape, axes, init="zeros",
                                      dtype=cfg.dtype)
            out["attn_v"] = ParamSpec(shape, axes, init="zeros",
                                      dtype=cfg.dtype)
        return out

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
        if "moe" in p:
            return h + moe_lib.moe_apply(p["moe"], hn, cfg)[0]
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
        h = self._scale_embeddings(h)

        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                h = self._ssm_step(_index(params["blocks"], i), h,
                                   cache["state"][i], cache["conv"][i])
        elif cfg.family == "hybrid":
            h = self._decode_hybrid(params, cache, h, pos)
        elif cfg.family == "moe":
            for blocks, layers in (("dense_blocks", "dense_layers"),
                                   ("moe_blocks", "moe_layers")):
                if blocks not in params:
                    continue
                kv = cache[layers]
                for i in range(kv["k"].shape[0]):
                    h = self._dense_step(_index(params[blocks], i), h,
                                         kv["k"][i], kv["v"][i], pos, "G")
        elif cfg.local_global_pattern:
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

    def _ssm_step(self, p, h, state, conv):
        """One mamba layer's decode step; ``state`` and ``conv`` are updated
        in place."""
        hn = rmsnorm(p["ln"], h, self.cfg.norm_eps)
        out, new_state, new_conv = ssm_lib.mamba2_decode_step(
            p["ssm"], hn, state, conv, self.cfg)
        state.copy_(new_state)
        conv.copy_(new_conv)
        return h + out

    def _decode_hybrid(self, params, cache, h, pos: int):
        cfg = self.cfg
        shared = params["shared_attn"]
        for n in range(params["mamba"]["ln"].shape[0]):
            hn = rmsnorm(shared["ln1"], h, cfg.norm_eps)
            a, _, _ = attn.gqa_decode(shared["attn"], hn, cache["attn_k"][n],
                                      cache["attn_v"][n], pos, self.shared_cfg,
                                      impl=self.attn_impl)
            h = h + a
            if "mlp" in shared:
                hn = rmsnorm(shared["ln2"], h, cfg.norm_eps)
                h = h + mlp(shared["mlp"], hn, cfg.mlp)
            for i in range(cfg.hybrid.shared_attn_period):
                h = self._ssm_step(_index(_index(params["mamba"], n), i), h,
                                   cache["state"][n, i], cache["conv"][n, i])
        return h

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
