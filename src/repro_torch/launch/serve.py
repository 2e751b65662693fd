"""Serving entry point: batched decode with a KV cache (PyTorch port of
``repro.launch.serve``).

Requests are batched with a fixed batch of left-aligned prompts.  Each prompt
is absorbed token by token through the decode step, then new tokens are
decoded greedily or sampled with a temperature.  It serves the dense, audio
and vlm families, the moe family (granite through the decode-attention
kernel; deepseek-v3's MLA layers over a cache of latents, in plain ops as in
JAX), mamba2 (ssm: the O(1) recurrence on a carried state) and zamba2
(hybrid: that recurrence, and the shared attention block through the
decode-attention kernel).

Greedy output is the JAX ``Server``'s, token for token.  Temperature sampling
draws from a ``torch.Generator`` seeded from ``job.seed``, so its tokens differ
from ``jax.random.categorical``'s: that is the one intended difference.

The server runs on the card unless the caller names another device; with no
CUDA device present and none named, it raises.

With a process group it serves on a ``DeviceMesh`` of (world // model_axis,
model_axis) as (data, model), by the decode rules, each rank on its own
card: the parameters and the cache are DTensors placed by their specs, the
kernels run on each rank's shards, and the logits are gathered whole before
sampling, so every rank generates the same tokens.  The CLI makes the
process group itself when ``torchrun`` starts it
(``launch.mesh.init_from_env``) and serves on (world, 1), as JAX's
``make_local_mesh`` does with its default ``model_axis``.

CLI:  python -m repro_torch.launch.serve --arch gemma-2b --smoke --tokens 16
      torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.distributed.sharding import (make_rules, make_shard_fn,
                                              place_tree, replicate,
                                              sharding_for_specs)
from repro_torch.launch.mesh import (destroy, init_from_env,
                                     make_local_mesh, rank_device)
from repro_torch.models.model import build_model


@dataclass
class ServeJob:
    arch: str = "gemma-2b"
    smoke: bool = True
    batch: int = 4
    prompt_len: int = 32
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    model_axis: int = 1
    device: Optional[str] = None      # None: the CUDA device


class Server:
    def __init__(self, job: ServeJob, params=None, device=None) -> None:
        device = device or job.device
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        self.job = job
        self.device = rank_device(device)
        cfg = get_arch(job.arch)
        if job.smoke:
            cfg = reduce_for_smoke(cfg)
        self.cfg = cfg
        self.mesh = make_local_mesh(job.model_axis, self.device.type)
        self.rules = make_rules("decode")
        self.model = build_model(cfg, shard_fn=make_shard_fn(self.mesh,
                                                             self.rules))
        if params is None:
            gen = torch.Generator(self.device).manual_seed(job.seed)
            params = self.model.init(gen, self.device)
        if self.mesh is not None:
            params = self._place(self.model.param_specs(), params)
        self.params = params
        with self.model.spmd():    # fp32, made once
            self.head = self.model.logits_weight(
                self.model.compute_params(params))
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0}

    def _place(self, specs, tree):
        """A tree every rank holds whole, as DTensors placed by ``specs``."""
        return place_tree(tree, sharding_for_specs(specs, self.mesh,
                                                   self.rules), self.mesh)

    def _step(self, cache, tokens: np.ndarray, pos: int):
        tok = torch.from_numpy(tokens).to(self.device, torch.int64)
        tok = self.model.shard(tok, ("batch",) + (None,) * (tok.ndim - 1))
        with self.model.spmd():
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   pos, head=self.head)
            if self.mesh is not None:
                logits = replicate(logits).to_local()
        return logits, cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts: np.ndarray, max_new_tokens: Optional[int] = None
                 ) -> np.ndarray:
        """prompts (B, P) int32 -> (B, P + new) generated ids (greedy/sampled).

        In ``torch.inference_mode()``, or under a mesh in ``no_grad``: a
        DTensor's views cannot be made of inference tensors."""
        with (torch.no_grad() if self.mesh is not None
              else torch.inference_mode()):
            return self._generate(prompts, max_new_tokens)

    def _generate(self, prompts: np.ndarray, max_new_tokens: Optional[int]
                  ) -> np.ndarray:
        job = self.job
        new = max_new_tokens or job.max_new_tokens
        B, P = prompts.shape
        total = P + new
        cache = self.model.init_cache(B, total, self.device)
        gen = torch.Generator(self.device).manual_seed(job.seed)
        out = np.zeros((B, total), np.int32)
        out[:, :P] = prompts
        t0 = time.perf_counter()
        # prompt absorption token-by-token through the decode path (the cache
        # layout then matches decode exactly)
        logits = None
        for t in range(P):
            logits, cache = self._step(cache, out[:, t], t)
        self._sync()
        self.stats["prefill_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in range(P, total):
            out[:, t] = self._sample(logits, gen).cpu().numpy()
            logits, cache = self._step(cache, out[:, t], t)
        self._sync()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["tokens"] += B * new
        return out

    def _sample(self, logits: torch.Tensor, gen: torch.Generator
                ) -> torch.Tensor:
        logits = logits[..., : self.cfg.vocab_size]
        if self.job.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.job.temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        picks = torch.multinomial(flat, 1, generator=gen)
        return picks.reshape(probs.shape[:-1]).to(torch.int32)

    def throughput(self) -> float:
        return self.stats["tokens"] / self.stats["decode_s"] \
            if self.stats["decode_s"] else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args()
    try:
        _main(args, init_from_env(args.device))
    finally:
        destroy()


def _main(args, device: Optional[str]) -> None:
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    job = ServeJob(arch=args.arch, smoke=args.smoke, batch=args.batch,
                   prompt_len=args.prompt_len, max_new_tokens=args.tokens,
                   temperature=args.temperature, device=device)
    server = Server(job)
    rng = np.random.default_rng(0)
    if job.smoke and server.cfg.num_codebooks:
        raise SystemExit("serve CLI demo targets text archs; musicgen decode "
                         "is covered by tests")
    prompts = rng.integers(0, server.cfg.vocab_size,
                           (job.batch, job.prompt_len)).astype(np.int32)
    out = server.generate(prompts)
    mesh = "" if server.mesh is None else \
        f", mesh {tuple(server.mesh.shape)}"
    say(f"generated {out.shape} | decode throughput "
        f"{server.throughput():.1f} tok/s "
        f"(batch {job.batch}, {server.device}{mesh})")
    say("sample ids:", out[0, job.prompt_len:job.prompt_len + 12].tolist())


if __name__ == "__main__":
    main()
