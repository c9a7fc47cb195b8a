"""The port's data pipeline against the JAX package's: batches bitwise
equal for the same (seed, step, process index), with and without
prefix embeddings and host sharding, and the reference tests'
properties (determinism in the step, prefetch order, disjoint host
shards, shifted labels)."""
import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as j_make_batch
from repro_torch.data.pipeline import DataConfig, Pipeline, make_batch

CONFIGS = [
    dict(vocab_size=100, seq_len=32, global_batch=4),
    dict(vocab_size=49_152, seq_len=512, global_batch=2, seed=7,
         mean_doc_len=64),
    dict(vocab_size=512, seq_len=128, global_batch=2, n_prefix_tokens=8,
         d_model=16),
    dict(vocab_size=100, seq_len=16, global_batch=8, process_index=1,
         process_count=2),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_batches_bitwise_equal_the_reference(kw):
    for step in (0, 1, 17, 123_456):
        want = j_make_batch(JDataConfig(**kw), step)
        got = make_batch(DataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), (key, step)


def test_batches_deterministic_in_step():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=4)
    b1, b2 = make_batch(cfg, 7), make_batch(cfg, 7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], make_batch(cfg, 8)["tokens"])


def test_prefetch_pipeline_order_and_content():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=2)
    pipe = Pipeline(cfg, start_step=5)
    try:
        got = [next(pipe) for _ in range(4)]
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for step, batch in got:
        np.testing.assert_array_equal(batch["tokens"],
                                      make_batch(cfg, step)["tokens"])


def test_host_sharding_disjoint():
    a = DataConfig(vocab_size=100, seq_len=16, global_batch=8,
                   process_index=0, process_count=2)
    b = DataConfig(vocab_size=100, seq_len=16, global_batch=8,
                   process_index=1, process_count=2)
    ba, bb = make_batch(a, 0), make_batch(b, 0)
    assert ba["tokens"].shape[0] == 4
    assert not np.array_equal(ba["tokens"], bb["tokens"])


def test_labels_are_shifted_tokens_and_prefix_is_masked():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=2)
    b = make_batch(cfg, 0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=2,
                     n_prefix_tokens=4, d_model=8)
    b = make_batch(cfg, 0)
    assert b["tokens"].shape == (2, 28)
    assert b["prefix_embeds"].shape == (2, 4, 8)
    assert (b["mask"][:, :4] == 0).all() and (b["mask"][:, 4:] == 1).all()
