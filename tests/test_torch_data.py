"""The port's lake-fed token stream on the CPU against the JAX package's.

Both packages build the same synthetic token corpus into their own copy of
the lake (``core``), and their ``TokenBatcher``s must stream the same
batches: array for array in sequential mode, with and without a TQL filter;
and, with ``shuffle=True``, the same documents in each epoch (the shuffled
order may depend on what the fetch engine holds).  ``DeviceFeeder`` on the
CPU must yield those batches as tensors.
"""

import numpy as np
import pytest
import torch

from repro.core.dataset import Dataset as JaxDataset
from repro.core.storage import MemoryProvider as JaxMemoryProvider
from repro.core.views import DatasetView as JaxDatasetView
from repro.data.pipeline import TokenBatcher as JaxTokenBatcher
from repro.data.synthetic import build_token_dataset as jax_build_token_dataset
from repro_torch.core.dataset import Dataset
from repro_torch.core.storage import MemoryProvider
from repro_torch.core.views import DatasetView
from repro_torch.data import DeviceFeeder, TokenBatcher, build_token_dataset

CORPUS = dict(num_docs=24, doc_len=256, vocab_size=1000, seed=3)
EVEN = "SELECT * FROM dataset WHERE doc_id % 2 == 0"


@pytest.fixture(scope="module")
def lakes():
    jds = jax_build_token_dataset(JaxDataset(JaxMemoryProvider()), **CORPUS)
    ds = build_token_dataset(Dataset(MemoryProvider()), **CORPUS)
    return jds, ds


def _views(lakes, tql):
    jds, ds = lakes
    if tql:
        return jds.query(tql), ds.query(tql)
    return JaxDatasetView.full(jds), DatasetView.full(ds)


@pytest.mark.parametrize("tql", [None, EVEN], ids=["full", "tql_even_docs"])
@pytest.mark.parametrize("num_codebooks", [0, 2])
def test_sequential_batches_equal_jax(lakes, tql, num_codebooks):
    jview, view = _views(lakes, tql)
    kw = dict(batch_size=2, seq_len=64, shuffle=False, seed=0,
              num_codebooks=num_codebooks)
    want = list(JaxTokenBatcher(jview, **kw))
    got = list(TokenBatcher(view, **kw))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _documents(batcher):
    return sorted(tuple(np.asarray(b["tokens"][0]).tolist())
                  for b in batcher.loader)


@pytest.mark.parametrize("tql", [None, EVEN], ids=["full", "tql_even_docs"])
def test_shuffled_epoch_streams_the_same_documents(lakes, tql):
    jview, view = _views(lakes, tql)
    kw = dict(batch_size=2, seq_len=64, shuffle=True, seed=1)
    want = _documents(JaxTokenBatcher(jview, **kw))
    got = _documents(TokenBatcher(view, **kw))
    assert got == want
    assert len(got) == (CORPUS["num_docs"] // 2 if tql else CORPUS["num_docs"])


def test_device_feeder_on_the_cpu_yields_the_batches(lakes):
    _, view = _views(lakes, None)
    host = list(TokenBatcher(view, batch_size=2, seq_len=64, shuffle=False))
    fed = list(DeviceFeeder(iter(host), "cpu"))
    assert len(fed) == len(host)
    for f, h in zip(fed, host):
        for k in h:
            assert f[k].device.type == "cpu"
            np.testing.assert_array_equal(f[k].numpy(), h[k])


def test_device_feeder_raises_what_its_source_raises():
    def broken():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise OSError("lake went away")

    it = iter(DeviceFeeder(broken(), "cpu"))
    assert torch.equal(next(it)["tokens"], torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(OSError, match="lake went away"):
        next(it)
