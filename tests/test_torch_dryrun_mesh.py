"""The dry run on fake process groups (``launch/dryrun.py``,
``launch/steps.py::abstract_state``/``trace_cell``, ``launch/op_analysis.py``):
each group is rank 0 of torch's "fake" backend in a process of its own
(``_torch_dryrun_tasks.py``), all started together when the module starts.

Per-device bytes are held against JAX's ``NamedSharding(AbstractMesh,
spec).shard_shape``; the counter against itself on real tensors; the
production cells against what they must show.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.distributed import sharding as jsh
from repro.models.model import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine

ROOT = Path(__file__).resolve().parents[1]
TASKS = Path(__file__).resolve().parent / "_torch_dryrun_tasks.py"
sys.path.insert(0, str(TASKS.parent))
NAMES = ["bytes_single", "bytes_multi", "abstract", "deepseek",
         "fake_vs_real", "allreduce", "prefill_mesh", "mesh_share",
         "seq_shard", "key_split_2x2", "key_split_1x4"]
CELL = ["--arch", "granite-moe-1b-a400m", "--shape", "decode_32k",
        "--mesh", "single", "--tag", "pytest"]
TIMEOUT = 600


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every task's JSON (or its process's error), the tasks run side by
    side; and the end-to-end cell under ``cell``."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, str(TASKS), name, str(d / f"{name}.json")],
        stdout=subprocess.DEVNULL, stderr=open(d / f"{name}.err", "w"),
        env=env, cwd=ROOT) for name in NAMES}
    procs["cell"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *CELL,
         "--out", str(d)], stdout=subprocess.DEVNULL,
        stderr=open(d / "cell.err", "w"), env=env, cwd=ROOT)
    out = {}
    try:
        for name, p in procs.items():
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        err = (d / f"{name}.err").read_text()[-3000:]
        if name == "cell":
            path = d / "granite-moe-1b-a400m__decode_32k__single__pytest.json"
            out[name] = (p.returncode, path, err)
        else:
            out[name] = json.loads((d / f"{name}.json").read_text()) \
                if p.returncode == 0 else err
    return out


def _get(results, name):
    got = results[name]
    assert not isinstance(got, str), got
    return got


# --------------------------------------------------------- per-device bytes
def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _shard_bytes(shape, dtype, spec, amesh) -> int:
    local = NamedSharding(amesh, PartitionSpec(*spec)).shard_shape(
        tuple(shape))
    return math.prod(local) * np.dtype(dtype).itemsize


def _jax_bytes(arch: str, shape: str, amesh) -> dict:
    """JAX's per-device bytes of one cell, its rules chosen as
    ``repro.launch.steps.build_cell`` chooses them."""
    cfg, sc = JAX_ARCHS[arch], JAX_SHAPES[shape]
    long_ctx = shape == "long_500k"
    seq_axis = None
    if cfg.seq_shard_attn and not long_ctx:
        seq_axis = "model" if sc.kind == "decode" else "data"
    rules = jsh.make_rules(sc.kind, long_context=long_ctx,
                           fsdp=cfg.fsdp_params, seq_shard=seq_axis)
    model = jax_build_model(cfg)

    def specs_bytes(specs):
        return sum(_shard_bytes(s.shape, s.dtype,
                                jsh.spec_for(s.shape, s.axes, amesh, rules),
                                amesh) for s in _leaves(specs))
    psp = model.param_specs()
    out = {"params": specs_bytes(psp)}
    if sc.kind == "train":
        opt = JaxAdamW(jax_cosine(3e-4, 100, 10_000),
                       moment_dtype=cfg.adam_moment_dtype)
        out["opt"] = specs_bytes(opt.state_specs(psp))
    if sc.kind in ("train", "prefill"):
        specs, shardings = jsh.batch_specs(cfg, sc, amesh, rules)
        out["inputs"] = sum(
            math.prod(shardings[k].shard_shape(v.shape)) * v.dtype.itemsize
            for k, v in specs.items())
    else:
        B = sc.global_batch
        out["cache"] = specs_bytes(model.cache_specs(B, sc.seq_len))
        tok_shape = (B, cfg.num_codebooks) if cfg.num_codebooks else (B,)
        tok_axes = ("batch", None) if cfg.num_codebooks else ("batch",)
        # the port's pos is a host int; JAX's, a 4-byte scalar
        out["inputs"] = _shard_bytes(
            tok_shape, np.int32, jsh.spec_for(tok_shape, tok_axes, amesh,
                                              rules), amesh)
    return out


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_per_device_bytes_equal_jax_for_every_cell(results, multi):
    got = _get(results, "bytes_multi" if multi else "bytes_single")
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi else \
        ((16, 16), ("data", "model"))
    amesh = AbstractMesh(shape, names)
    assert len(got) == 33      # every runnable cell
    for cell, port in got.items():
        arch, shape_name = cell.split("/")
        assert port == _jax_bytes(arch, shape_name, amesh), cell


# ------------------------------------------------------------ abstract state
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v3-671b",
                                  "zamba2-2.7b"])
def test_abstract_state_matches_init_state_and_place_tree(results, arch):
    got = _get(results, "abstract")[arch]
    assert got["fake"] == got["real"]
    assert len(got["fake"]) > 10
    # some leaf is split on each mesh dim, so this is no world of one
    placements = [p for _, _, pl, _ in got["fake"].values() for p in pl]
    assert "S(0)" in placements or "S(1)" in placements


# ------------------------------------------------------- what the step shows
def test_smoke_deepseek_train_step_traces_on_fake_tensors(results):
    """MLA's attention on a (2, 2) mesh under ``FakeTensorMode``: DTensor
    could not place the einsum's merged batch and head dims without reading
    values, which a fake tensor has not."""
    got = _get(results, "deepseek")
    assert got["metrics"] == ["aux", "ce", "grad_norm", "loss", "mtp"]
    assert got["state"]["params/moe_blocks/attn/w_uk"] == [3, 32, 2, 32]


@pytest.mark.parametrize("where", ["none", "mesh", "phi3_mesh"])
def test_counts_are_equal_on_fake_and_real_tensors(results, where):
    """``phi3_mesh``: smoke phi-3-vision under ``attn_impl="torch"`` on
    (2, 2), which did not trace: DTensor merged the batch split and the
    head split into one dim, whose ``bmm`` it places only by reading
    values; the plain impls now run on each rank's shards."""
    got = _get(results, "fake_vs_real")[where]
    assert got["fake"] == got["real"]
    assert got["fake"]["flops"] > 0 and got["fake"]["peak_bytes"] > 0
    if where != "none":
        assert got["fake"]["collective_count"]["reduce-scatter"] > 0


def test_decode_on_a_key_split_cache_gathers_no_cache(results):
    """A smoke decode step on (2, 2) under --seq-shard's rules (the cache's
    keys split over "model") all-gathers what the decode rules' step does
    and, each layer, only the new token's q, k and v made whole along the
    key split; the cache stays in place (it was all-gathered each layer).
    The merge adds to the decode rules' all-reduces (the hidden state's,
    whole over "model") one of the lse max and one of the weighted
    outputs with their weights, (B/data, H) and (B/data, H, D + 1), and at
    most those buffers of one layer to the decode rules' peak (a gathered
    cache would add a layer's whole K and V, 32,768 B).  Both peaks were
    the embedding table's re-lay (1,513,992 B) while the lookup moved the
    whole table, which hid the merge's buffers."""
    from _torch_dryrun_tasks import SEQ_KV_HEADS
    got = _get(results, "seq_shard")
    default, seq = got["default"], got["seq_shard"]
    assert (default["seq_rule"], seq["seq_rule"]) == (None, "model")
    L, H, D, B = got["cfg"]
    B_loc, fp32 = B // 2, 4
    token = L * B_loc * (H + 2 * SEQ_KV_HEADS) * D * fp32
    assert seq["collective_by_kind"]["all-gather"] == \
        default["collective_by_kind"]["all-gather"] + token
    assert seq["collective_by_kind"]["all-reduce"] == \
        default["collective_by_kind"]["all-reduce"] + \
        L * B_loc * H * (1 + D + 1) * fp32
    assert seq["kernel_calls"] == default["kernel_calls"] == \
        {"decode_attention": L}
    merge = B_loc * H * (D + 2) * fp32
    assert seq["peak_bytes"] <= default["peak_bytes"] + merge


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v3-671b"])
def test_key_split_decode_gathers_only_the_token(results, arch, mesh):
    """A smoke decode step under --seq-shard's rules all-gathers what the
    decode rules' step does plus, each layer, the token's operands made
    whole along the key split, at two cache lengths alike: no latent, key
    or score grows the count with T.  GQA's are q, k and v (on (1, 4) k
    and v are whole under both rules: their two heads do not divide
    "model"); MLA's, the absorbed query (B/data, H, r + rope).  The merge
    all-reduces the lse max and the weighted outputs with their weights."""
    from _torch_dryrun_tasks import KEY_SPLIT_T, SEQ_SHAPE
    got = _get(results, f"key_split_{mesh}")[arch]
    data = 2 if mesh == "2x2" else 1
    L, H, Hkv, D = got["widths"][:4]
    B_loc, fp32 = SEQ_SHAPE.global_batch // data, 4
    if arch == "deepseek-v3-671b":
        r, rope = got["widths"][4:]
        token, out_width = H * (r + rope), r
    else:
        token = (H + 2 * Hkv) * D if data == 2 else H * D
        out_width = D
    for T in KEY_SPLIT_T:
        default, seq = got[f"default_{T}"], got[f"seq_shard_{T}"]
        assert seq["all-gather"] == default.get("all-gather", 0) + \
            L * B_loc * token * fp32, (T, seq, default)
        assert seq["all-reduce"] == default.get("all-reduce", 0) + \
            L * B_loc * H * (1 + out_width + 1) * fp32, (T, seq, default)
    assert len({tuple(sorted(got[f"seq_shard_{T}"].items()))
                for T in KEY_SPLIT_T}) == 1


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_mla_decode_under_the_decode_rules_reduces_no_score(results, mesh):
    """A smoke deepseek-v3 decode step under the decode rules, at two cache
    lengths: the same collectives at both, and no reduce-scatter under
    either cache rule (that of a (B/data, H, T) score grew with T, 16 B a
    position a layer on (2, 2), while a split of x's d left the rope query
    a pending sum).  The hidden state is whole over "model", so the rope
    query comes out of its projection on q_abs's head split, and the
    step's only all-reduces are, each (B/data, 1, d) fp32, the looked-up
    rows' and two a layer, and each of the 3 MoE layers' sums: of its
    dispatched rows over the experts' ranks, (B/data * top_k, d), and on
    (2, 2) over "data" of its (E/model, C, d) expert buffer (C = 8), its
    (E,) routing fractions and (E,) router probabilities.  Exactly:
    64,704 B on (2, 2) and 30,720 B on (1, 4)."""
    from _torch_dryrun_tasks import KEY_SPLIT_T, SEQ_SHAPE
    got = _get(results, f"key_split_{mesh}")["deepseek-v3-671b"]
    L = got["widths"][0]
    _, d, fp32 = got["table"]
    data, model = (2, 2) if mesh == "2x2" else (1, 4)
    B, E, k, moe, C = SEQ_SHAPE.global_batch // data, 8, 2, 3, 8
    rows = (1 + 2 * L) * B * d + moe * B * k * d
    buffers = moe * (E // model * C * d + 2 * E) if data > 1 else 0
    for T in KEY_SPLIT_T:
        assert got[f"default_{T}"]["all-reduce"] == (rows + buffers) * fp32
        assert got[f"default_{T}"] == got[f"default_{KEY_SPLIT_T[0]}"], T
        for rule in ("default", "seq_shard"):
            assert "reduce-scatter" not in got[f"{rule}_{T}"], (rule, T)
    assert got[f"default_{KEY_SPLIT_T[0]}"]["all-reduce"] == \
        (64704 if mesh == "2x2" else 30720)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v3-671b"])
def test_lookup_moves_only_the_rows_reduction(results, arch, mesh):
    """The embedding lookup of a real train and decode step (counted inside
    ``Model.lookup``), each rank's tokens in its own vocab shard: the table
    comes in whole along d (``compute_params``' fsdp gather of the rank's
    vocab shard, counted with the step), so the lookup sends only the
    reduction of the looked-up rows, one all-reduce onto the hidden state
    whole over "model": of a train step's (B/data, S, d), of decode's
    (B/data, 1, d).  DTensor's own lookup moved the
    whole table (the decode rules' vocab split) to a split along d."""
    from _torch_dryrun_tasks import KEY_SPLIT_T, SEQ_SHAPE, SMOKE_TRAIN
    got = _get(results, f"key_split_{mesh}")[arch]
    _, d, fp32 = got["table"]
    data, model = (2, 2) if mesh == "2x2" else (1, 4)
    B = SMOKE_TRAIN.global_batch // data
    assert got["lookup_train"]["by_kind"] == {
        "all-reduce": B * SMOKE_TRAIN.seq_len * d * fp32}
    B = SEQ_SHAPE.global_batch // data
    for T in KEY_SPLIT_T:
        assert got[f"lookup_{T}"]["by_kind"] == {
            "all-reduce": B * d * fp32}, T
        assert set(got[f"lookup_{T}"]["count"].values()) == {1}


@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v3-671b"])
def test_decode_step_moves_no_table_bytes_on_a_model_axis_of_4(results,
                                                               arch):
    """A smoke decode step on the fake (1, 4) group, under both cache
    rules and at both cache lengths: no collective it sends carries as
    many bytes as one rank's vocab shard of the embedding table (DTensor's
    lookup re-laid the whole table, 262,144 B here, every token)."""
    from _torch_dryrun_tasks import KEY_SPLIT_T
    got = _get(results, "key_split_1x4")[arch]
    V, d, fp32 = got["table"]
    for T in KEY_SPLIT_T:
        for rule in ("default", "seq_shard"):
            assert 0 < got[f"{rule}_{T}_largest"] < V // 4 * d * fp32, \
                (rule, T)


def test_lookup_on_the_production_mesh(results):
    """Smoke gemma-2b (its vocabulary 4096) on (16, 16): a train step's and
    a decode step's lookup all-reduce the rows onto a hidden state whole
    over "model" and send nothing else; the table came in whole along d
    from ``compute_params``' fsdp gather of the rank's vocab shard over
    "data"."""
    got = _get(results, "mesh_share")
    d = got["lookup_widths"][1]
    assert got["lookup"]["train"]["by_kind"] == {
        "all-reduce": 256 // 16 * 64 * d * 4}
    assert got["lookup"]["decode"]["by_kind"] == {
        "all-reduce": 256 // 16 * d * 4}


def test_shard_to_shard_redistribution_counts_one_all_to_all(results):
    """On a "cpu" mesh DTensor turns Shard(1) -> Shard(0) into an
    all-gather of 8 times the bytes and a chunk; the counter counts what a
    "cuda" mesh sends: one all-to-all of the rank's (128, 256) fp32
    result, and no all-gather."""
    got = _get(results, "allreduce")["alltoall"]
    assert got["local"] == [128, 256]
    assert got["collective_count"] == {"all-to-all": 1}
    assert got["collective_by_kind"] == {"all-to-all": 128 * 256 * 4}
    assert got["hbm_bytes"] == 0


def test_collectives_detected_on_sharded_matmul(results):
    """The port of ``test_hlo_analysis``'s check: a contraction dim split
    over 8 ranks needs a reduction."""
    got = _get(results, "allreduce")
    assert got["collective_count"] == {"all-reduce": 1}
    assert got["collective_bytes"] == 1024 * 256 * 4
    assert got["flops"] == 2 * 1024 * 32 * 256        # one rank's share
    assert got["collective_bytes_across_nodes"] == 0   # 8 ranks, one node


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-1.3b"])
def test_prefill_on_a_mesh_places_its_cache(results, arch):
    """A prefill on a mesh copied each layer's DTensor K/V (or SSM state)
    into a plain cache tensor, which DTensor refuses; the cache is now
    placed by the rules, each rank making its shard."""
    got = _get(results, "prefill_mesh")[arch]
    assert got["logits"] == [4, 512]
    assert got["cache"]
    for shape, placements in got["cache"].values():
        assert len(placements) == 2
    if arch == "gemma-2b":
        assert got["cache"]["layers/k"][1] == ["S(1)", "R"]


# ------------------------------------------------- each rank's share
def test_train_step_holds_no_global_logits(results):
    """A smoke gemma-2b step on (16, 16), its vocabulary and batch such that
    the whole batch's fp32 logits would outweigh everything else a rank
    holds: the loss's backward makes no tensor of their shape (DTensor's
    gradient of a gather along a split dim did), and the counted peak stays
    under a quarter of them."""
    from _torch_dryrun_tasks import SHARE_GEMMA, SHARE_GEMMA_SHAPE
    peak, largest = _get(results, "mesh_share")["gemma"]
    s = SHARE_GEMMA_SHAPE
    logits = s.global_batch * s.seq_len * SHARE_GEMMA["vocab_size"] * 4
    assert peak < logits / 4
    assert largest < logits / 16


def test_moe_step_holds_no_global_token_table(results):
    """A smoke granite step on (16, 16), one expert a model rank: no
    storage reaches a quarter of the whole (T*k, d) table of dispatched
    rows, which the dispatch held on every rank before."""
    from _torch_dryrun_tasks import SHARE_GRANITE_SHAPE
    got = _get(results, "mesh_share")
    E, k, d = got["granite_moe"]
    assert E == 16
    _, largest = got["granite"]
    s = SHARE_GRANITE_SHAPE
    table = s.global_batch * s.seq_len * k * d * 4
    assert largest < table / 4


def test_init_cache_counts_its_shards_and_no_meta_storage(results):
    """``init_cache`` on the fake mesh: the counted peak is exactly its
    shards' bytes (a global stride taken from a meta tensor was counted as
    a whole fp32 cache)."""
    got = _get(results, "mesh_share")["cache"]
    assert got["peak"] == got["shards"] > 0
    assert got["global"] > got["shards"]


def test_dryrun_cell_end_to_end(results):
    """One full-width cell through the CLI: granite-moe-1b-a400m x
    decode_32k on 256 fake ranks, JSON out."""
    rc, path, err = results["cell"]
    assert rc == 0, err
    d = json.loads(path.read_text())
    assert d["status"] == "OK"
    assert d["chips"] == 256
    assert d["roofline"]["flops_per_device"] > 0
    assert d["memory_analysis"]["alias_bytes"] > 0   # the cache, in place
    assert d["kernel_calls"] == {"decode_attention": 24}
