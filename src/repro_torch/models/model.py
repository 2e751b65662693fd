"""Model assembly for training, prefill and decode (PyTorch port of
``repro.models.model``).

Carried through ``loss_fn``, ``prefill`` and ``decode_step``:

    dense   - starcoder2 / qwen2 / gemma / gemma3 / musicgen / phi3v backbones
              (with the audio and vlm families)
    moe     - deepseek-v3 (MLA + 1 shared + 256 routed, sigmoid router,
              leading dense layers, multi-token prediction), granite (GQA +
              32 routed experts)
    ssm     - mamba2 (attention-free SSD, through the ssd-scan kernel)
    hybrid  - zamba2 (mamba2 backbone + one SHARED GQA block every N layers)

The moe family's ``loss_fn`` adds 0.01 times the load-balance loss summed
over the MoE layers, as JAX's does, and reports it as ``metrics["aux"]``;
with ``mtp_depth``, also 0.3 times the multi-token prediction loss,
``metrics["mtp"]``.  MLA layers decode over a cache of latents (``ckv``,
``kr``) in place of K and V.

``prefill`` runs a prompt through the layers without ``maybe_remat`` and
returns the last token's logits and a cache of the prompt's length, with
the leaf paths, shapes and dtypes of ``cache_specs(B, S)``; decode continues
from it at position S once its time axes are padded to the decode length.
Its attention goes through the flash kernel under ``kernel``; its mamba
layers scan through the plain ``ssd_chunked`` under every impl, as JAX's
``ssm_lib_prefill`` does.

Parameters are a nested dict of tensors with the JAX package's paths
(``blocks/attn/wq``), stacked with a leading layer axis as there; a Python
loop over the layer index (or the period, for local/global patterns and
zamba2) takes the place of ``lax.scan``, with ``maybe_remat`` around each
training iteration as JAX puts it around the scan body.  zamba2's shared
attention block is closed over, not stacked, so its gradient sums over every
invocation.

API:
    m = build_model(cfg)                            # attn_impl: attention.IMPLS
    specs  = m.param_specs()                        # ParamSpec tree
    params = m.init(generator, device)              # real tensors
    loss, metrics = m.loss_fn(params, batch)        # train forward
    logits, cache = m.prefill(params, batch)        # last logits, cache of S
    cache  = m.init_cache(batch, max_len, device)
    head   = m.logits_weight(params)                # fp32, once per params
    logits, cache = m.decode_step(params, cache, tokens, pos, head=head)
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (batch_call, gather_axes,
                                              sharded, sharding_for_specs)
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (embed, maybe_remat, mlp, mlp_specs, rmsnorm,
                     softmax_cross_entropy)
from .param import (ParamSpec, materialize, named_leaves, torch_dtype,
                    tree_map, unflatten)


Identity = lambda x, axes=None: x


def _ln(d: int, stack: Tuple[int, ...] = ()) -> ParamSpec:
    return ParamSpec(stack + (d,), (None,) * len(stack) + (None,), init="ones",
                     dtype="float32")


# the parameter trees stacked with a leading layer (or period) axis
STACKED = ("blocks", "dense_blocks", "moe_blocks", "mamba", "periods", "tail")


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
    def __init__(self, cfg: ModelConfig, shard_fn: Callable = Identity,
                 attn_impl: str = "kernel") -> None:
        if cfg.family not in ("dense", "audio", "vlm", "moe", "ssm", "hybrid"):
            raise ValueError(cfg.family)
        if cfg.family != "ssm" and cfg.attention not in ("gqa", "mla"):
            raise ValueError(f"{cfg.name}: unknown attention "
                             f"{cfg.attention!r}")
        if attn_impl not in attn.IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r}")
        self.cfg = cfg
        self.shard = shard_fn
        self.attn_impl = attn_impl
        if cfg.family == "hybrid":      # zamba2's shared attention block
            hb = cfg.hybrid
            self.shared_cfg = cfg.with_(
                num_heads=hb.shared_attn_heads,
                num_kv_heads=hb.shared_attn_kv_heads,
                head_dim=cfg.d_model // hb.shared_attn_heads)

    # ------------------------------------------------------------ param specs
    def _attn_specs(self, stack):
        if self.cfg.attention == "mla":
            return attn.mla_specs(self.cfg, stack)
        return attn.gqa_specs(self.cfg, stack)

    def _dense_block_specs(self, stack):
        cfg = self.cfg
        return {
            "ln1": _ln(cfg.d_model, stack),
            "attn": self._attn_specs(stack),
            "ln2": _ln(cfg.d_model, stack),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.dtype, stack),
        }

    def _moe_block_specs(self, stack):
        cfg = self.cfg
        return {
            "ln1": _ln(cfg.d_model, stack),
            "attn": self._attn_specs(stack),
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
            if cfg.mtp_depth:
                specs["mtp"] = {
                    "proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                      ("fsdp", None), dtype=cfg.dtype),
                    "block": self._dense_block_specs(()),
                    "ln": _ln(cfg.d_model),
                }
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

    def compute_params(self, params):
        """The parameters as the model computes with them: under a mesh,
        every tree but the stacked layers (``STACKED``) made whole by
        :meth:`_whole`; the layers stay split until each layer's own
        :meth:`_whole` call, inside its ``maybe_remat``, so that one layer
        at a time is whole, as GSPMD gathers a ZeRO-3 weight per use.
        Without a mesh, ``params`` as they are."""
        return {k: v if k in STACKED else self._whole(v)
                for k, v in params.items()}

    def _whole(self, p):
        """A parameter tree as its layers compute with it: each DTensor whole
        over the mesh axes of the "fsdp" rule (the all-gather of a ZeRO-3
        weight, whose backward reduce-scatters its gradient) and still split
        over the model axis; plain tensors as they are.  DTensor's rules
        cannot contract a batch-split activation with a weight split over
        the same mesh axis on another dim (an ``einsum`` that views across
        the split), where GSPMD gathers the weight."""
        axes = getattr(self.shard, "rules", {}).get("fsdp")
        if not axes:
            return p
        return tree_map(lambda t: gather_axes(t, axes), p)

    def spmd(self):
        """The context the model runs in under a mesh: plain tensors made
        inside (positions, masks, rope tables) count as whole on every
        rank."""
        if getattr(self.shard, "mesh", None) is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    # ------------------------------------------------------------- block fwd
    def _dense_block(self, p, h, positions, kind: str, aux=None):
        """-> (h, aux): a layer with ``"moe"`` adds its load-balance loss to
        ``aux``; any other passes ``aux`` through."""
        cfg = self.cfg
        p = self._whole(p)
        window = cfg.sliding_window if kind == "L" else 0
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        if cfg.attention == "mla":
            a = attn.mla_train(p["attn"], hn, positions, cfg,
                               impl=self.attn_impl)
        else:
            a = attn.gqa_train(p["attn"], hn, positions, cfg, window=window,
                               impl=self.attn_impl)
        h = self.shard(h + a, ("batch", None, None))
        hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
        if "moe" in p:
            out, aux_i = moe_lib.moe_apply(p["moe"], hn, cfg, shard=self.shard)
            aux = aux + aux_i
        else:
            out = mlp(p["mlp"], hn, cfg.mlp)
        return self.shard(h + out, ("batch", None, None)), aux

    def _ssm_block(self, p, h):
        # both plain attention impls scan through ssd_chunked, as JAX maps
        # every impl but pallas to xla
        p = self._whole(p)
        hn = rmsnorm(p["ln"], h, self.cfg.norm_eps)
        return self.shard(h + ssm_lib.mamba2_forward(
            p["ssm"], hn, self.cfg,
            impl="kernel" if self.attn_impl == "kernel" else "torch"),
            ("batch", None, None))

    def _shared_attn_block(self, p, h, positions):
        cfg = self.cfg
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        # pinned as a dense block's: left as the attention's pending sum
        # over the model axis, the norm's square would reduce-scatter it
        # over the sequence
        h = self.shard(h + attn.gqa_train(p["attn"], hn, positions,
                                          self.shared_cfg,
                                          impl=self.attn_impl),
                       ("batch", None, None))
        if "mlp" in p:
            hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
            h = h + mlp(p["mlp"], hn, cfg.mlp)
        return self.shard(h, ("batch", None, None))

    # --------------------------------------------------------------- embed
    def _scale_embeddings(self, h):
        # the scale is rounded to h's dtype before the product, as in JAX
        return h * torch.tensor(math.sqrt(self.cfg.d_model), dtype=h.dtype,
                                device=h.device)

    def lookup(self, table, tokens, axes=("batch", None, None)):
        """Token embeddings, scaled: tokens (B, S), or (B, K, S) summed over
        the K codebook tables -> (B, S, d), placed by the logical ``axes``
        (under a mesh, the rows' pending sum over the vocab's split reduced
        onto them); ``table`` as the model computes with it."""
        tokens = tokens.long()
        if self.cfg.num_codebooks:
            h = None
            for k in range(self.cfg.num_codebooks):
                e = embed(table[k], tokens[:, k])
                h = e if h is None else h + e
        else:
            h = embed(table, tokens)
        return self.shard(self._scale_embeddings(h), axes)

    def _embed_tokens(self, params, batch):
        cfg = self.cfg
        h = self.lookup(params["embed"], batch["tokens"])
        if cfg.num_image_tokens and "image_embeds" in batch:
            # on each rank's batch shard: the cat's backward may hand the
            # image rows' gradient split over the tokens on "model", and the
            # projection's weight gradient would then contract over a batch
            # and token split merged into one strided dim, which DTensor
            # places only by reading values
            img = batch_call(lambda x, w: x.to(w.dtype) @ w,
                             batch["image_embeds"], params["img_proj"])
            h = torch.cat([img, h[:, cfg.num_image_tokens:]], dim=1)
        return self.shard(h, ("batch", None, None))

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
        [, image_embeds] -> (loss, {"ce", "loss"}); the moe family adds
        "aux", and with multi-token prediction "mtp"."""
        cfg = self.cfg
        params = self.compute_params(params)
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
        head = self.logits_weight(params)   # one fp32 copy for both losses
        logits = self._logits(params, h, head)
        logits = self.shard(logits, ("batch", None, "vocab") if logits.ndim == 3
                            else ("batch", None, None, "vocab"))
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
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth and "mtp" in params:
            mtp_loss = self._mtp_loss(params, h, batch, head)
            loss = loss + 0.3 * mtp_loss
            metrics["mtp"] = mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, params, h, batch, head):
        """DeepSeek-V3 multi-token prediction (depth 1, simplified, as JAX's):
        at position i, the final-normed ``h`` combined with the unscaled
        embedding of token i+1 predicts token i+2, through one dense block
        at positions 0 .. S-2."""
        cfg = self.cfg
        p = params["mtp"]
        tokens, targets = batch["tokens"], batch["targets"]
        # the rows' pending sum over the vocab's split reduced here: carried
        # into the block, it left the latent projection's weight gradient a
        # contraction over a strided split, which DTensor places only by
        # reading values
        e_next = self.shard(embed(params["embed"], tokens[:, 1:].long()),
                            ("batch", None, None))
        h_in = torch.cat([rmsnorm(p["ln"], h[:, :-1], cfg.norm_eps), e_next],
                         dim=-1)
        h_in = (h_in @ p["proj"]).to(h.dtype)
        B, S1 = tokens.shape[0], tokens.shape[1] - 1
        positions = torch.arange(S1, dtype=torch.int32,
                                 device=tokens.device).expand(B, S1)
        hm, _ = self._dense_block(p["block"], h_in, positions, "G")
        logits = self._logits(params, rmsnorm(params["final_ln"], hm,
                                              cfg.norm_eps), head)
        mask = batch.get("loss_mask")
        return softmax_cross_entropy(logits, targets[:, 1:],
                                     mask[:, 1:] if mask is not None else None)

    # ----------------------------------------------------------------- prefill
    def prefill(self, params, batch, *, head: Optional[torch.Tensor] = None):
        """A prompt through the layers -> (the last token's logits, the
        cache of length S): tokens (B,S) or (B,K,S) [, image_embeds], as
        ``loss_fn`` takes them.  Logits are (B,V), or (B,K,V) with
        codebooks; ``head`` is ``logits_weight(params)``, if the caller has
        it.  The norm and logits are taken of the last position only."""
        cfg = self.cfg
        params = self.compute_params(params)
        tokens = batch["tokens"]
        B, S = tokens.shape[0], tokens.shape[-1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        h = self._embed_tokens(params, batch)
        cache = self.init_cache(B, S, tokens.device)
        h = self._backbone_with_cache(params, h, positions, cache)
        h = rmsnorm(params["final_ln"], h[:, -1:], cfg.norm_eps)
        return self._logits(params, h, head)[:, 0], cache

    def _dense_prefill(self, p, h, positions, kind: str):
        """One layer's forward -> (h, its cache: (k, v), or the MLA
        latents (ckv, kr))."""
        cfg = self.cfg
        p = self._whole(p)
        window = cfg.sliding_window if kind == "L" else 0
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        if cfg.attention == "mla":
            a, kv = attn.mla_prefill(p["attn"], hn, positions, cfg,
                                     impl=self.attn_impl)
        else:
            a, kv = attn.gqa_prefill(p["attn"], hn, positions, cfg,
                                     window=window, impl=self.attn_impl)
        h = self.shard(h + a, ("batch", None, None))
        hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
        if "moe" in p:
            out = moe_lib.moe_apply(p["moe"], hn, cfg, shard=self.shard)[0]
        else:
            out = mlp(p["mlp"], hn, cfg.mlp)
        return self.shard(h + out, ("batch", None, None)), kv

    def _backbone_with_cache(self, params, h, positions, cache):
        """The layers' forward, each layer's cache written into its slot of
        ``cache`` (``init_cache(B, S)``) -> h."""
        cfg = self.cfg

        def put(leaves, at, parts):
            for leaf, part in zip(leaves, parts):
                leaf[at].copy_(part)

        if cfg.family == "ssm":
            for i, p in enumerate(_unbind(params["blocks"])):
                p = self._whole(p)
                hn = rmsnorm(p["ln"], h, cfg.norm_eps)
                out, state, conv = ssm_lib_prefill(p["ssm"], hn, cfg,
                                                   self.attn_impl)
                h = self.shard(h + out, ("batch", None, None))
                put((cache["state"], cache["conv"]), i, (state, conv))
            return h
        if cfg.family == "hybrid":
            shared = params["shared_attn"]
            for n, p in enumerate(_unbind(params["mamba"])):
                hn = rmsnorm(shared["ln1"], h, cfg.norm_eps)
                a, kv = attn.gqa_prefill(shared["attn"], hn, positions,
                                         self.shared_cfg, impl=self.attn_impl)
                h = self.shard(h + a, ("batch", None, None))
                put((cache["attn_k"], cache["attn_v"]), n, kv)
                if "mlp" in shared:
                    hn = rmsnorm(shared["ln2"], h, cfg.norm_eps)
                    h = self.shard(h + mlp(shared["mlp"], hn, cfg.mlp),
                                   ("batch", None, None))
                for i, layer in enumerate(_unbind(p)):
                    layer = self._whole(layer)
                    hn = rmsnorm(layer["ln"], h, cfg.norm_eps)
                    out, state, conv = ssm_lib_prefill(layer["ssm"], hn, cfg,
                                                       self.attn_impl)
                    h = self.shard(h + out, ("batch", None, None))
                    put((cache["state"], cache["conv"]), (n, i),
                        (state, conv))
            return h
        if cfg.family == "moe":
            names = ("ckv", "kr") if cfg.attention == "mla" else ("k", "v")
            for blocks, layers in (("dense_blocks", "dense_layers"),
                                   ("moe_blocks", "moe_layers")):
                for i, p in enumerate(_unbind(params[blocks])
                                      if blocks in params else ()):
                    h, kv = self._dense_prefill(p, h, positions, "G")
                    put([cache[layers][name] for name in names], i, kv)
            return h
        if cfg.local_global_pattern:
            pat = cfg.local_global_pattern
            local, glob = cache["periods_local"], cache["periods_global"]
            for n, p in enumerate(_unbind(params["periods"])):
                li = gi = 0
                for layer, kind in zip(_unbind(p), pat):
                    h, kv = self._dense_prefill(layer, h, positions, kind)
                    if kind == "L":
                        put((local["k"], local["v"]), (n, li), kv)
                        li += 1
                    else:
                        put((glob["k"], glob["v"]), (n, gi), kv)
                        gi += 1
            if "tail" in params:
                tail = cache["tail"]
                for i, p in enumerate(_unbind(params["tail"])):
                    h, kv = self._dense_prefill(p, h, positions, pat[0])
                    put((tail["k"], tail["v"]), i, kv)
            return h
        kind = "L" if cfg.sliding_window else "G"
        layers = cache["layers"]
        for i, p in enumerate(_unbind(params["blocks"])):
            h, kv = self._dense_prefill(p, h, positions, kind)
            put((layers["k"], layers["v"]), i, kv)
        return h

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
            layers = kv
            if cfg.attention == "mla":
                layers = functools.partial(self._mla_cache_specs, batch)
            out = {"moe_layers": layers((cfg.num_layers - nd,), max_len)}
            if nd:
                out["dense_layers"] = layers((nd,), max_len)
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

    def _mla_cache_specs(self, batch: int, stack, max_len: int):
        """MLA's cache: the normed latents ``ckv`` (..., B, T, r) and the
        rotated rope key ``kr`` (..., B, T, rd), in the model's dtype."""
        cfg, m = self.cfg, self.cfg.mla
        seq_ax = "seq" if cfg.seq_shard_attn else None
        axes = (None,) * len(stack) + ("batch", seq_ax, None)
        return {name: ParamSpec(tuple(stack) + (batch, max_len, width), axes,
                                init="zeros", dtype=cfg.dtype)
                for name, width in (("ckv", m.kv_lora_rank),
                                    ("kr", m.rope_head_dim))}

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
        """Zeros of ``cache_specs``; under a mesh, DTensors placed by the
        model's rules, each rank making only its own shard."""
        specs = self.cache_specs(batch, max_len)
        mesh = getattr(self.shard, "mesh", None)
        if mesh is None:
            # every cache leaf is zeros, so no generator is drawn from
            return materialize(specs, None, device)
        placements = dict(named_leaves(sharding_for_specs(
            specs, mesh, self.shard.rules)))
        return unflatten(
            (path, sharded(torch.zeros, s.shape, torch_dtype(s.dtype), mesh,
                           placements[path], device))
            for path, s in named_leaves(specs))

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
            # a product a codebook: on a mesh, the einsum's (K, vocab) dims
            # merge into one strided-split dim, which DTensor places only by
            # reading values (a fake tensor has none)
            logits = torch.stack([hf @ w[:, k] for k in
                                  range(cfg.num_codebooks)], dim=2)
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
        """One layer's decode step; for MLA, ``ck`` and ``cv`` are the
        layer's ``ckv`` and ``kr`` caches."""
        cfg = self.cfg
        p = self._whole(p)
        window = cfg.sliding_window if kind == "L" else 0
        hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
        if cfg.attention == "mla":
            a, ck, cv = attn.mla_decode(p["attn"], hn, ck, cv, pos, cfg)
        else:
            a, ck, cv = attn.gqa_decode(p["attn"], hn, ck, cv, pos, cfg,
                                        window=window, impl=self.attn_impl)
        h = self.shard(h + a, ("batch", None, None))
        hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
        if "moe" in p:
            out = moe_lib.moe_apply(p["moe"], hn, cfg)[0]
        else:
            out = mlp(p["mlp"], hn, cfg.mlp)
        return self.shard(h + out, ("batch", None, None))

    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int, *,
                    head: Optional[torch.Tensor] = None):
        """One token for the whole batch. tokens (B,) or (B,K) int64; pos a
        host int.  Returns (logits, cache); the cache is updated in place.

        ``head`` is ``logits_weight(params)``, made once by a caller that
        decodes many steps.

        Under a mesh the hidden state (B, 1, d) is split over the batch
        only and whole over "model", from the lookup (the rows' pending sum
        over the vocab's split all-reduced onto it) to the last layer: each
        layer pins it so after its attention and after its MLP, as the
        training layers pin theirs, so that every torch version's DTensor
        sends the same two all-reduces a layer and does not choose its own
        placement (a split of d costs a reduce-scatter, an all-gather and
        the norm's all-reduce a layer).
        """
        cfg = self.cfg
        params = self.compute_params(params)
        h = self.lookup(params["embed"], tokens[..., None])     # (B,1,d)

        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                h = self._ssm_step(_index(params["blocks"], i), h,
                                   cache["state"][i], cache["conv"][i])
        elif cfg.family == "hybrid":
            h = self._decode_hybrid(params, cache, h, pos)
        elif cfg.family == "moe":
            names = ("ckv", "kr") if cfg.attention == "mla" else ("k", "v")
            for blocks, layers in (("dense_blocks", "dense_layers"),
                                   ("moe_blocks", "moe_layers")):
                if blocks not in params:
                    continue
                first, second = (cache[layers][n] for n in names)
                for i in range(first.shape[0]):
                    h = self._dense_step(_index(params[blocks], i), h,
                                         first[i], second[i], pos, "G")
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
        in place (under a mesh, each rank's own shards of them)."""
        p = self._whole(p)
        hn = rmsnorm(p["ln"], h, self.cfg.norm_eps)
        out = ssm_lib.mamba2_decode_step(p["ssm"], hn, state, conv,
                                         self.cfg)[0]
        return self.shard(h + out, ("batch", None, None))

    def _decode_hybrid(self, params, cache, h, pos: int):
        cfg = self.cfg
        shared = params["shared_attn"]
        for n in range(params["mamba"]["ln"].shape[0]):
            hn = rmsnorm(shared["ln1"], h, cfg.norm_eps)
            a, _, _ = attn.gqa_decode(shared["attn"], hn, cache["attn_k"][n],
                                      cache["attn_v"][n], pos, self.shared_cfg,
                                      impl=self.attn_impl)
            h = self.shard(h + a, ("batch", None, None))
            if "mlp" in shared:
                hn = rmsnorm(shared["ln2"], h, cfg.norm_eps)
                h = self.shard(h + mlp(shared["mlp"], hn, cfg.mlp),
                               ("batch", None, None))
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


def ssm_lib_prefill(p, hn, cfg, attn_impl):
    """Mamba2 prefill: the layer's forward, its final SSM state (B,nh,N,P)
    in fp32 and its conv tail (B,K-1,conv_dim), the last K-1 inputs of the
    conv before it, left-padded with zeros when S < K-1.  The scan runs
    through the plain ``ssd_chunked`` under every impl, as in JAX, which
    takes ``attn_impl`` and does not use it either."""
    s = cfg.ssm
    K = s.conv_kernel
    out, h_final, xbc_raw = ssm_lib.ssd_per_shard(
        lambda x, dt, A, Bm, Cm: ssm_lib.ssd_chunked(x, dt, A, Bm, Cm,
                                                     chunk=s.chunk_size),
        p, hn @ p["in_proj"], cfg)
    # per batch shard: DTensor's pad fails on some torch versions
    conv_tail = batch_call(lambda x: F.pad(
        x, (0, 0, max(0, K - 1 - x.shape[1]), 0))[:, -(K - 1):], xbc_raw)
    return out, h_final, conv_tail


def build_model(cfg: ModelConfig, shard_fn: Callable = Identity,
                attn_impl: str = "kernel") -> Model:
    return Model(cfg, shard_fn=shard_fn, attn_impl=attn_impl)
