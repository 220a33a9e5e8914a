"""The port's data pipeline against the JAX package: the same numpy draw,
so the same tokens for every (seed, step, host); prefetch order and resume
and the loader's effect ordering as ``tests/test_data.py`` checks them."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as J  # noqa: E402
from repro_torch.core import TaskKind, execute_sequential, trace  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher, SyntheticLMDataset,  # noqa: E402
                                       make_data_source)


@pytest.mark.parametrize("vocab,seq,batch,n_hosts,seed", [
    (512, 16, 2, 1, 0), (152064, 64, 4, 1, 3), (1000, 8, 16, 4, 1)])
def test_batches_equal_the_references(vocab, seq, batch, n_hosts, seed):
    for host in range(n_hosts):
        mine = SyntheticLMDataset(vocab, seq, batch, n_hosts=n_hosts,
                                  host_id=host, seed=seed)
        ref = J.SyntheticLMDataset(vocab, seq, batch, n_hosts=n_hosts,
                                   host_id=host, seed=seed)
        for step in (0, 1, 7, 123):
            got, want = mine.batch_at(step), ref.batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])


def test_batch_at_deterministic_and_step_addressed():
    ds = SyntheticLMDataset(1000, 16, 8, seed=3)
    a, b, c = ds.batch_at(5), ds.batch_at(5), ds.batch_at(6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (8, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 1000


def test_prefetcher_yields_in_order_and_resumes():
    ds = SyntheticLMDataset(1000, 8, 4, seed=2)
    pf = Prefetcher(ds, start_step=10, depth=2)
    try:
        for step in (10, 11):
            np.testing.assert_array_equal(pf.next()["tokens"],
                                          ds.batch_at(step)["tokens"])
        assert pf.step == 12
    finally:
        pf.close()
    pf2 = Prefetcher(ds, start_step=12, depth=2)
    try:
        np.testing.assert_array_equal(pf2.next()["tokens"],
                                      ds.batch_at(12)["tokens"])
    finally:
        pf2.close()


def test_data_source_is_effectful_and_ordered():
    ds = SyntheticLMDataset(1000, 8, 4)
    load = make_data_source(ds)
    g, _ = trace(lambda: (load(), load(), load()))
    nodes = list(g)
    assert all(n.kind is TaskKind.EFFECTFUL for n in nodes)
    assert nodes[1].token_deps == (nodes[0].tid,)
    assert nodes[2].token_deps == (nodes[1].tid,)
    res = execute_sequential(g)
    np.testing.assert_array_equal(res[0]["tokens"], ds.batch_at(0)["tokens"])
    np.testing.assert_array_equal(res[2]["tokens"], ds.batch_at(2)["tokens"])
