"""The three models ``chip_smoke.py``'s ``family`` phases bring to the card
(starcoder2-3b: a sliding window and qkv bias; phi-3-vision-4.2b: the
image-embedding splice; musicgen-medium: codebooks) on the CPU at smoke
size.

* ``Trainer.run`` (lake-fed, ``device="cpu"``) step by step against the JAX
  package's ``build_model`` and ``make_train_step`` on the batches the
  trainer drew and its initial state, carried through numpy.  The JAX
  ``Trainer`` itself fails under the installed jax, so its step stands in.
  Tolerances as ``tests/test_torch_train.py``'s: loss and gradient norm at
  1e-4 relative, params and moments at 1e-4 of each leaf's largest value,
  both optimizers at eps 1e-6.
* The card script's prefill-then-decode helpers (``_continue``,
  ``_last_logits``) with codebooks and image embeddings, against JAX's
  ``prefill`` and ``decode_step`` (1e-4) and the train forward (2e-2).
* The ``family`` phases end to end on the CPU (the smoke configs, the card's
  memory calls stubbed), whose launch checks raise if a count is off; the
  wrappers count no launch on the CPU, so the attention module's calls to
  them are counted instead.  And the full-width counts pinned.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce_for_smoke
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.model import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
import repro_torch.models.attention as attn_lib
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.serve import ServeJob
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import Trainer, TrainJob
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.models.param import tree_map
from repro_torch.optim import AdamW, cosine_schedule

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RTOL = 1e-4
FORWARD_RTOL = 2e-2
EPS = 1e-6      # tests/test_torch_train.py: updates fixed by the gradients
FAMILIES = ["starcoder2-3b", "phi-3-vision-4.2b", "musicgen-medium"]


def _np_tree(tree):
    return tree_map(lambda t: t.detach().clone().numpy(), tree)


def _assert_tree_close(got_tree, want_tree, what):
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, want_tree)))
    got = dict(named_leaves(got_tree))
    assert set(got) == set(want), what
    for path, w in want.items():
        g = got[path].detach().float().numpy().astype(np.float64)
        w = w.astype(np.float64)
        err = np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-30)
        assert err <= RTOL, (what, path, err)


# ------------------------------------------------------------ Trainer.run
@pytest.mark.parametrize("arch", ["musicgen-medium", "phi-3-vision-4.2b"])
def test_trainer_run_matches_jax_train_steps(arch):
    job = TrainJob(arch=arch, steps=3, global_batch=2, seq_len=32, lr=1e-3,
                   warmup=1, checkpoint_every=3, num_docs=8, log_every=100,
                   device="cpu")
    trainer = Trainer(job)
    trainer.opt = AdamW(cosine_schedule(job.lr, job.warmup, job.steps),
                        eps=EPS)
    step_fn = make_train_step(trainer.model, trainer.opt)
    seen = {"batches": [], "metrics": []}

    def recorded(state, batch):     # the batches drawn, the state before
        if not seen["batches"]:
            seen["state"] = _np_tree(state)
        seen["batches"].append({k: v.numpy().copy() for k, v in batch.items()})
        state, metrics = step_fn(state, batch)
        seen["metrics"].append({k: float(v) for k, v in metrics.items()})
        return state, metrics
    trainer.step_fn = recorded
    out = trainer.run(restore=False)
    assert out["final_step"] == job.steps

    batches = seen["batches"]
    cfg = trainer.cfg
    K = cfg.num_codebooks
    assert batches[0]["tokens"].shape == (2,) + ((K,) if K else ()) + (32,)
    if cfg.num_image_tokens:
        assert batches[0]["image_embeds"].shape == (2, cfg.num_image_tokens,
                                                    1024)
    jcfg = jax_reduce_for_smoke(jax_get_arch(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jopt = JaxAdamW(jax_cosine_schedule(job.lr, job.warmup, job.steps),
                    eps=EPS)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jopt))
    jstate = jax.tree_util.tree_map(jnp.asarray, seen["state"])
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            want = float(jmetrics[key])
            assert abs(seen["metrics"][i][key] - want) <= RTOL * abs(want), \
                (i, key, seen["metrics"][i][key], want)
    assert [h["loss"] for h in out["history"]] == \
        [m["loss"] for m in seen["metrics"]]
    _assert_tree_close(out["state"]["params"], jstate["params"], "params")
    for moment in ("m", "v"):
        _assert_tree_close(out["state"]["opt"][moment], jstate["opt"][moment],
                           moment)


# ------------------------------------------------- the card script's helpers
def _setup(arch, S, steps, B=2):
    jcfg = jax_reduce_for_smoke(jax_get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(8)
    K = cfg.num_codebooks
    tokens = rng.integers(0, cfg.vocab_size, (B,) + ((K,) if K else ())
                          + (S + steps,)).astype(np.int32)
    extra = {}
    if cfg.num_image_tokens:
        extra["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, 1024)).astype(np.float32)
    return jcfg, cfg, np_params, tokens, extra


def _jax_continuation(jcfg, np_params, tokens, extra, S):
    """JAX: prefill S positions, the cache zero-padded, decode the rest ->
    (n + 1, B, [K,] V)."""
    model = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    B, T = tokens.shape[0], tokens.shape[-1]
    last, cache = jax.jit(model.prefill)(
        params, {"tokens": jnp.asarray(tokens[..., :S]),
                 **{k: jnp.asarray(v) for k, v in extra.items()}})
    cache = jax.tree_util.tree_map(
        lambda leaf, spec: jnp.pad(leaf, [(0, want - have) for have, want in
                                          zip(leaf.shape, spec.shape)]),
        cache, model.cache_specs(B, T))
    step = jax.jit(model.decode_step)
    out = [np.asarray(last)]
    for t in range(S, T):
        logits, cache = step(params, cache, jnp.asarray(tokens[..., t]),
                             jnp.int32(t))
        out.append(np.asarray(logits))
    return np.stack(out)[..., :jcfg.vocab_size]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,S", [("starcoder2-3b", 128),
                                    ("phi-3-vision-4.2b", 32),
                                    ("musicgen-medium", 32)])
def test_card_continuation_helpers_match_jax_and_forward(arch, S):
    """``_continue`` and ``_last_logits`` as ``[past_window_*]`` runs them:
    starcoder2 at twice its smoke window, so that decode writes ring slots
    0..7 over the oldest keys; phi-3-vision with its image embeddings in
    the prefill and the forward; musicgen on (B, K, T) grids."""
    steps = 8
    jcfg, cfg, np_params, tokens, extra = _setup(arch, S, steps)
    want = _jax_continuation(jcfg, np_params, tokens, extra, S)
    model = build_model(cfg)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    tt = torch.from_numpy(tokens).long()
    ex = {k: torch.from_numpy(v) for k, v in extra.items()}
    got, flash, decode = chip_smoke._continue(model, params, tt, S, None, ex)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= RTOL
    fwd = chip_smoke._last_logits(model, params, tt, None, steps + 1, ex)
    assert _rel(got, fwd.movedim(1, 0)) < FORWARD_RTOL
    # the splice reaches the continuation: other image embeddings move it
    if extra:
        other = {"image_embeds": ex["image_embeds"] + 1.0}
        moved = chip_smoke._continue(model, params, tt, S, None, other)[0]
        assert _rel(moved, got) > RTOL


# ------------------------------------------------------- the family phases
def _expected(cfg, steps=8, prompt=32, new=32, past=chip_smoke.PAST_STEPS):
    """A ``family`` run's launches: the training run and its ``[dryrun]``
    step (twice a layer under remat "full"), the served tokens (with
    codebooks, a prefill and ``new`` decode steps), the served dtype's
    prefill and ``past`` decode steps."""
    L = chip_smoke._attention_layers(cfg)
    per = 2 if cfg.remat == "full" else 1
    flash = per * L * (steps + 1) + L
    if cfg.num_codebooks:
        return {"flash_attention": flash + L,
                "decode_attention": L * (new + past)}
    return {"flash_attention": flash,
            "decode_attention": L * (prompt + new + past)}


def test_family_launch_counts_at_full_width():
    """The counts the card's run must show, at the published depths (no
    ``TRAIN_CUT`` for these three)."""
    assert not set(FAMILIES) & set(chip_smoke.TRAIN_CUT)
    assert [chip_smoke._attention_layers(get_arch(a)) for a in FAMILIES] == \
        [30, 32, 48]
    want = {"starcoder2-3b": (480, 540, 2400), "phi-3-vision-4.2b":
            (512, 576, 2560), "musicgen-medium": (768, 864, 2304)}
    for arch, (train, with_dryrun, decode) in want.items():
        cfg = get_arch(arch)
        job = chip_smoke.FAMILY_JOBS[arch]
        assert (job.steps, job.global_batch, job.seq_len) == (8, 4, 1024)
        assert chip_smoke.train_launches(cfg, job.steps) == \
            {"flash_attention": train, "ssd_scan": 0}
        L = chip_smoke._attention_layers(cfg)
        got = _expected(cfg)
        assert got["flash_attention"] == with_dryrun + L * (
            2 if cfg.num_codebooks else 1)
        assert got["decode_attention"] == decode
    # starcoder2 past its window: the prompt a multiple of it, the decode on
    # ring slots 0 .. PAST_STEPS - 1
    W = get_arch("starcoder2-3b").sliding_window
    assert chip_smoke.PAST_PROMPT["starcoder2-3b"] == 2 * W
    assert chip_smoke.PAST_PROMPT["phi-3-vision-4.2b"] > \
        get_arch("phi-3-vision-4.2b").num_image_tokens


@pytest.fixture
def on_the_cpu(monkeypatch):
    """``chip_smoke`` pointed at the smoke configs on the CPU: the card's
    memory calls stubbed, the attention module's kernel calls counted."""
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "get_arch",
                        lambda a: reduce_for_smoke(get_arch(a)))
    monkeypatch.setattr(chip_smoke, "ServeJob", lambda **kw: ServeJob(
        **dict(kw, smoke=True, device="cpu")))
    monkeypatch.setattr(chip_smoke, "FAMILY_JOBS", {
        a: dataclasses.replace(j, smoke=True, device="cpu", seq_len=64,
                               lr=3e-3)
        for a, j in chip_smoke.FAMILY_JOBS.items()})
    monkeypatch.setattr(chip_smoke, "PAST_PROMPT", {
        "starcoder2-3b": 128, "phi-3-vision-4.2b": 32, "musicgen-medium": 32})
    for name in ("flash_attention", "decode_attention"):
        fn = getattr(attn_lib, name)

        def counted(*a, _name=name, _fn=fn, **k):
            chip_smoke.COUNTED[_name].launches += 1
            return _fn(*a, **k)
        monkeypatch.setattr(attn_lib, name, counted)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_phases_run_on_the_cpu(arch, on_the_cpu, capsys):
    """Every gate of the phases holds at smoke size (losses falling, launch
    counts, the [dryrun] calls, kernel vs torch, prefill and the
    continuation past the prompt against the forward), and the launches
    returned are the formula's.  The [dryrun] reads the trace that
    ``_dryrun_cells`` names for the phase, made ahead in a process of its
    own, as ``main`` makes them."""
    cells = [c for c in chip_smoke._dryrun_cells() if c[0].name == arch]
    pool = chip_smoke.trace_ahead(cells)
    try:
        got = chip_smoke.family("cpu", arch)
    finally:
        pool.shutdown()
    assert got == _expected(reduce_for_smoke(get_arch(arch)))
    assert not chip_smoke._TRACES
    lines = capsys.readouterr().out
    tag = chip_smoke.FAMILY_TAGS[arch]
    for phase in ("train", "serve", "past_window"):
        assert f"[{phase}_{tag}] " in lines
    assert '"traced_ahead": true' in lines


def test_a_trace_made_ahead_equals_one_made_inline():
    cell = (reduce_for_smoke(get_arch("gemma-2b")), 2, 64, "decode")
    pool = chip_smoke.trace_ahead([cell])
    try:
        ahead = chip_smoke._TRACES.pop(cell).result()
    finally:
        pool.shutdown()
    inline = chip_smoke.dryrun_count(*cell)
    for key in ("costs", "memory", "active"):
        assert ahead[key] == inline[key], key
