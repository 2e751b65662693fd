"""The port's TQL tensor engine (``engine="torch"``) on the CPU against the
JAX package's XLA engine (``engine="jax"``) and the numpy engine.

Both packages build the same lakes from the same seed: the fixture of
``tests/test_tql.py`` and the lake of ``benchmarks/bench_tql.py``.  Queries
must select the same rows in all three engines, streamed, top-k and sharded
alike; each batched TQL function must give JAX's values in JAX's dtype, at
rtol 1e-6 (the two engines accumulate in different orders and widths: the
port in float64, XLA in float32).
"""

import numpy as np
import pytest
import torch

import repro.core as jdl
from repro.core.tql import execute_query as jax_execute_query
from repro.core.tql import parse as jax_parse
from repro.core.tql.executor import VectorEval as JaxVectorEval
from repro.core.views import DatasetView as JaxDatasetView
from repro_torch import tql_engine
from repro_torch.core.dataset import Dataset
from repro_torch.core.storage import MemoryProvider
from repro_torch.core.tql import execute_query, parse
from repro_torch.core.tql import executor
from repro_torch.core.views import DatasetView

RTOL = 1e-6
TEST_TQL = "SELECT * FROM dataset WHERE MEAN(images) > 120 AND NOT labels == 1"
BENCH_TQL = ("SELECT * FROM dataset WHERE MEAN(v) > 0.02 AND lab != 3 "
             "ORDER BY MEAN(v) DESC LIMIT 256")


def _tql_fixture(ds):
    """``tests/test_tql.py``'s fixture lake, built into ``ds``."""
    rng = np.random.default_rng(7)
    ds.create_tensor("images", htype="image", dtype="uint8",
                     sample_compression="raw", min_chunk_size=1 << 14,
                     max_chunk_size=1 << 16)
    ds.create_tensor("labels", htype="class_label")
    ds.create_tensor("boxes", htype="bbox", strict=False)
    ds.group("training").create_tensor("boxes", htype="bbox", strict=False)
    ds.create_tensor("caption", htype="text")
    words = ["cat", "dog", "car", "sky"]
    for i in range(40):
        gt = rng.uniform(0, 24, (2, 4)).astype(np.float32)
        gt[:, 2:] += gt[:, :2]
        ds.append({
            "images": rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
            "labels": np.int64(i % 4),
            "boxes": (gt + rng.normal(0, 1.0, gt.shape)).astype(np.float32),
            "training/boxes": gt,
            "caption": np.frombuffer(f"a {words[i % 4]} photo".encode(),
                                     dtype=np.uint8).copy(),
        })
    ds.commit("fixture")
    return ds


def _bench_lake(ds):
    """``benchmarks/bench_tql.py``'s lake, built into ``ds``."""
    rng = np.random.default_rng(0)
    ds.create_tensor("v", dtype="float32", min_chunk_size=1 << 18,
                     max_chunk_size=1 << 20)
    ds.create_tensor("lab", htype="class_label")
    for i in range(4000):
        ds.append({"v": rng.standard_normal(64).astype(np.float32),
                   "lab": np.int64(i % 13)})
    ds.commit("bench")
    return ds


@pytest.fixture(scope="module")
def tql_lakes():
    return _tql_fixture(jdl.dataset()), _tql_fixture(Dataset(MemoryProvider()))


@pytest.fixture(scope="module")
def bench_lakes():
    return _bench_lake(jdl.dataset()), _bench_lake(Dataset(MemoryProvider()))


@pytest.fixture
def torch_evals(monkeypatch):
    """The devices on which ``VectorEval`` evaluated with the torch engine."""
    seen = []
    inner = executor.VectorEval.eval

    def counted(self, node):
        out = inner(self, node)
        if self.engine == "torch":
            seen.append(self.xp.device)
        return out
    monkeypatch.setattr(executor.VectorEval, "eval", counted)
    return seen


def _three_engines(lakes, q, **kw):
    jds, ds = lakes
    want = execute_query(ds, q, engine="numpy", **kw).indices.tolist()
    jax = jax_execute_query(jds, q, engine="jax", **kw).indices.tolist()
    got = execute_query(ds, q, engine="torch", device="cpu", **kw)
    return want, jax, got


def test_engines_agree_on_test_tql_query(tql_lakes, torch_evals):
    want, jax, got = _three_engines(tql_lakes, TEST_TQL)
    assert got.indices.tolist() == jax == want
    assert 0 < len(want) < 40
    assert torch_evals and set(torch_evals) == {torch.device("cpu")}


def test_engines_agree_on_bench_topk_query(bench_lakes, torch_evals):
    want, jax, got = _three_engines(bench_lakes, BENCH_TQL)
    assert got.indices.tolist() == jax == want
    assert len(want) == 256
    assert got.topk_plan is not None or len(bench_lakes[1]) <= 256
    assert torch_evals


@pytest.mark.parametrize("shards", [None, 2])
def test_streamed_multigroup_where(tql_lakes, torch_evals, shards):
    q = "SELECT * FROM dataset WHERE MAX(images) > 253 OR labels == 2"
    want, jax, got = _three_engines(tql_lakes, q, stream=True, shards=shards)
    assert got.indices.tolist() == jax == want
    assert len(torch_evals) > 1            # one evaluation per chunk group


# each batched function on columns of each type: images uint8 (32,32,3),
# boxes float32 (2,4), labels int64 (a scalar a row)
EXPRESSIONS = [
    "MEAN(images)", "MEAN(boxes)", "MEAN(images > 100)",
    "SUM(boxes)", "SUM(images > 100)", "SUM(labels)",
    "MAX(images)", "MAX(boxes)", "MIN(images)", "MIN(boxes)",
    "STD(images)", "STD(boxes)",
    "ABS(boxes - 10)", "ABS(labels - 2)",
    "SQRT(images)", "SQRT(boxes)", "SQRT(labels)",
    "CLIP(images, 10, 200)", "CLIP(boxes, 0.5, 20.5)",
    "ANY(images > 250)", "ALL(images > 0)", "ANY(boxes > 30)",
    "L2_NORM(images)", "L2_NORM(boxes)", "L2_NORM(labels)",
    "CAST_FLOAT(images)", "CAST_FLOAT(labels)",
    "RANDOM()", "labels * 2 + 1", "boxes / 4",
]


def _values(tql_lakes, expr, engine):
    jds, ds = tql_lakes
    q = f"SELECT * FROM dataset WHERE {expr}"
    if engine == "jax":
        return np.asarray(JaxVectorEval(JaxDatasetView.full(jds), 3, "jax")
                          .eval(jax_parse(q).where))
    return executor.VectorEval(DatasetView.full(ds), 3, engine, "cpu").eval(
        parse(q).where)


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_batched_values_match_jax(tql_lakes, expr):
    """JAX's dtype, and JAX's values within RTOL.  Where the numpy engine
    computes at least as wide (float64, or float32 with numpy's pairwise
    sums), it referees: the port must be within RTOL of it, and may differ
    from JAX by RTOL plus JAX's own distance from it.  XLA's float32 sums
    stray further than RTOL (by 1.2e-6 for the 3072-element sums of squares
    of L2_NORM(images)); the port's float64 sums do not."""
    want = _values(tql_lakes, expr, "jax")
    exact = _values(tql_lakes, expr, "numpy")
    got = _values(tql_lakes, expr, "torch")
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape == exact.shape
    if got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
        return
    want64 = want.astype(np.float64)
    slack = 0.0
    if exact.dtype.itemsize >= got.dtype.itemsize:
        np.testing.assert_allclose(got, exact, rtol=RTOL, atol=0)
        slack = np.abs(want64 - exact)
    near = np.abs(got - want64) <= RTOL * np.abs(want64) + slack
    assert (near | (np.isnan(got) & np.isnan(want))).all()


def test_sum_of_uint8_is_int64_where_jax_has_uint32(tql_lakes):
    """The one dtype the engine does not share with JAX's: torch has no
    arithmetic on uint32.  The values are JAX's."""
    want = _values(tql_lakes, "SUM(images)", "jax")
    got = _values(tql_lakes, "SUM(images)", "torch")
    assert (want.dtype, got.dtype) == (np.uint32, np.int64)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_no_card_and_no_device_raises(tql_lakes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no|none"):
        execute_query(tql_lakes[1], TEST_TQL, engine="torch")
    with pytest.raises(RuntimeError):
        tql_engine.TorchNamespace()


def test_jax_engine_name_raises_and_names_torch(tql_lakes):
    with pytest.raises(ValueError, match="torch"):
        execute_query(tql_lakes[1], TEST_TQL, engine="jax")


def test_namespace_narrows_as_jax_does():
    xp = tql_engine.TorchNamespace("cpu")
    assert xp.asarray(np.zeros(3)).dtype == torch.float32
    assert xp.asarray(np.zeros(3, np.int64)).dtype == torch.int32
    assert xp.asarray([1, 2]).dtype == torch.int32
    assert xp.asarray(np.zeros(3, np.uint8)).dtype == torch.uint8
    assert xp.full((2,), np.nan, dtype="float64").dtype == torch.float32
    t = xp.asarray(np.arange(24, dtype=np.uint8).reshape(2, 3, 4))
    np.testing.assert_array_equal(xp.to_numpy(xp.std(t, axis=(1, 2))),
                                  np.std(np.arange(24).reshape(2, 12), axis=1)
                                  .astype(np.float32))
    # numpy's axis=() reduces nothing (torch's dim=() would reduce all)
    v = np.array([3.0, -4.0], np.float32)
    for name in ("sum", "mean", "max", "min", "std", "any", "all"):
        want = getattr(np, name)(v, axis=())
        got = xp.to_numpy(getattr(xp, name)(xp.asarray(v), axis=()))
        np.testing.assert_array_equal(got, want, err_msg=name)
