"""Port parity: the synthetic LM data pipeline (``tests/test_data.py``'s
cases, each against the reference's stream bit for bit)."""
import numpy as np
import pytest

from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import SyntheticLM


def _equal(a, b):
    assert a.keys() == b.keys() == {"tokens", "targets"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (1000, 32, 8, 1), (128, 64, 8, 0), (151936, 16, 3, 7)])
def test_stream_is_the_reference_stream(vocab, seq, batch, seed):
    a, b = SyntheticLM(vocab, seq, batch, seed=seed), JSyntheticLM(
        vocab, seq, batch, seed=seed)
    for _ in range(4):
        _equal(next(a), next(b))


def test_targets_are_shifted_tokens():
    d = next(SyntheticLM(1000, 16, 2, seed=0))
    np.testing.assert_array_equal(d["tokens"][:, 1:], d["targets"][:, :-1])


def test_seek_matches_continuous_stream():
    cont = SyntheticLM(1000, 16, 4, seed=9)
    batches = [next(cont) for _ in range(5)]
    seeked = SyntheticLM(1000, 16, 4, seed=9)
    next(seeked)
    seeked.seek(3)
    _equal(next(seeked), batches[3])
    ref = JSyntheticLM(1000, 16, 4, seed=9)
    ref.seek(4)
    _equal(next(seeked), next(ref))


def test_host_shards_are_disjoint_and_the_references():
    shards = []
    for host in (0, 1):
        got = next(SyntheticLM(1000, 16, 8, seed=5, n_hosts=2, host_id=host))
        _equal(got, next(JSyntheticLM(1000, 16, 8, seed=5, n_hosts=2,
                                      host_id=host)))
        assert got["tokens"].shape == (4, 16)
        shards.append(got["tokens"])
    assert not np.array_equal(*shards)
    with pytest.raises(ValueError):
        SyntheticLM(1000, 16, 9, n_hosts=2)


def test_prefetch_fills_ahead():
    d = SyntheticLM(1000, 8, 2, seed=3, prefetch=3)
    d.fill()
    assert len(d._queue) == 3 and d._next_step == 3
    first = next(d)
    assert len(d._queue) == 2
    _equal(first, next(JSyntheticLM(1000, 8, 2, seed=3)))
