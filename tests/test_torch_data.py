"""The port's data pipeline held against the reference's (CPU): the same
batches bit for bit.

``repro_torch.data.pipeline`` is a copy of the reference's pure-numpy
module, so ``SyntheticLM.batch_at`` (zipfian unigrams with a repeated
n-gram, drawn from ``SeedSequence([seed, step])``) and ``BinCorpus``
(memmapped windows, wrapping at the end of the file) must give the very
same arrays, as must ``host_batch_slice`` and ``make_pipeline``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("step", [0, 1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_equal_the_reference(seed, step):
    kw = dict(vocab_size=128, seq_len=32, global_batch=4, seed=seed)
    _same(tpipe.SyntheticLM(**kw).batch_at(step),
          jpipe.SyntheticLM(**kw).batch_at(step))


@pytest.mark.parametrize("kw", [
    dict(vocab_size=262_144, seq_len=64, global_batch=2),
    dict(vocab_size=50, seq_len=8, global_batch=8, zipf_a=1.5,
         ngram_period=4)])
def test_synthetic_batches_at_other_settings(kw):
    for step in (0, 5):
        _same(tpipe.SyntheticLM(**kw).batch_at(step),
              jpipe.SyntheticLM(**kw).batch_at(step))
    b = tpipe.SyntheticLM(**kw).batch_at(0)
    assert b["tokens"].dtype == np.int32
    assert (b["tokens"] >= 0).all() and (b["tokens"] < kw["vocab_size"]).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_bin_corpus_equals_the_reference(tmp_path, dtype, step):
    """Windows of a flat token file, including the wrap at EOF (103 tokens
    at S = 16 leave a short last window, and later steps wrap the row
    index)."""
    rng = np.random.default_rng(1)
    top = 1000 if dtype == "uint16" else 300_000
    path = tmp_path / f"toks_{dtype}.bin"
    rng.integers(0, top, 103).astype(dtype).tofile(path)
    kw = dict(path=str(path), vocab_size=777, seq_len=16, global_batch=3,
              dtype=dtype)
    tc, jc = tpipe.BinCorpus(**kw), jpipe.BinCorpus(**kw)
    assert tc.n_tokens == jc.n_tokens == 103
    _same(tc.batch_at(step), jc.batch_at(step))


def test_bin_corpus_wraps_at_eof(tmp_path):
    """A window that runs past the file's end continues from its start."""
    path = tmp_path / "short.bin"
    np.arange(20, dtype=np.uint16).tofile(path)
    b = tpipe.BinCorpus(str(path), vocab_size=100, seq_len=16,
                        global_batch=2).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][1], np.arange(16))
    _same(b, jpipe.BinCorpus(str(path), vocab_size=100, seq_len=16,
                             global_batch=2).batch_at(0))


@pytest.mark.parametrize("count", [1, 2, 4])
def test_host_batch_slice(count):
    batch = tpipe.SyntheticLM(64, 8, 8, seed=2).batch_at(3)
    parts = [tpipe.host_batch_slice(batch, i, count) for i in range(count)]
    for i, part in enumerate(parts):
        _same(part, jpipe.host_batch_slice(batch, i, count))
    _same({k: np.concatenate([p[k] for p in parts]) for k in batch}, batch)


def test_make_pipeline_and_data_state(tmp_path):
    syn = tpipe.make_pipeline("synthetic", vocab_size=64, seq_len=8,
                              global_batch=2, seed=5)
    assert syn == tpipe.SyntheticLM(64, 8, 2, seed=5)
    path = tmp_path / "t.bin"
    np.arange(50, dtype=np.uint16).tofile(path)
    binp = tpipe.make_pipeline("bin", vocab_size=64, seq_len=8,
                               global_batch=2, path=str(path))
    _same(binp.batch_at(1), jpipe.make_pipeline(
        "bin", vocab_size=64, seq_len=8, global_batch=2,
        path=str(path)).batch_at(1))
    with pytest.raises(ValueError, match="unknown pipeline"):
        tpipe.make_pipeline("tfrecord", vocab_size=1, seq_len=1,
                            global_batch=1)
    st = tpipe.DataState(step=torch.zeros((), dtype=torch.int32))
    assert st.step.dtype == torch.int32 and st.step.shape == ()
