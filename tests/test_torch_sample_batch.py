"""The port's SampleBatch / MultiAgentBatch invariants, property-based
(``tests/test_sample_batch.py``), each case also held against the
reference's ``SampleBatch`` on the same columns."""

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property-based tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro.rl.sample_batch import SampleBatch as JaxSampleBatch
from repro_torch.rl.sample_batch import MultiAgentBatch, SampleBatch


def make_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return SampleBatch(
        obs=rng.standard_normal((n, 4)),
        actions=rng.integers(0, 2, n),
        rewards=rng.standard_normal(n),
    )


@given(st.lists(st.integers(min_value=0, max_value=20), min_size=1, max_size=6))
@settings(max_examples=30, deadline=None)
def test_concat_count_additive(sizes):
    batches = [make_batch(n, i) for i, n in enumerate(sizes)]
    out = SampleBatch.concat_samples(batches)
    assert out.count == sum(sizes)
    want = JaxSampleBatch.concat_samples([JaxSampleBatch(dict(b.items())) for b in batches])
    for k in want.keys():
        np.testing.assert_array_equal(out[k], want[k])


@given(
    st.integers(min_value=1, max_value=50),
    st.integers(min_value=0, max_value=49),
    st.integers(min_value=1, max_value=50),
)
@settings(max_examples=30, deadline=None)
def test_slice_bounds(n, start, length):
    b = make_batch(n)
    end = min(start + length, n)
    s = b.slice(min(start, n), end)
    assert s.count == max(0, end - min(start, n))
    want = JaxSampleBatch(dict(b.items())).slice(min(start, n), end)
    for k in want.keys():
        np.testing.assert_array_equal(s[k], want[k])


@given(st.integers(min_value=1, max_value=64), st.integers(min_value=1, max_value=16))
@settings(max_examples=30, deadline=None)
def test_minibatches_partition(n, mb):
    b = make_batch(n)
    rows = sum(m.count for m in b.minibatches(mb))
    assert rows == (n // mb) * mb  # full minibatches only
    for m in b.minibatches(mb):
        assert m.count == mb


def test_ragged_rejected():
    with pytest.raises(ValueError):
        SampleBatch(a=np.zeros(3), b=np.zeros(4))


def test_shuffle_preserves_rows():
    b = make_batch(16)
    s = b.shuffle(np.random.default_rng(0))
    assert sorted(s["rewards"].tolist()) == sorted(b["rewards"].tolist())
    # rows stay aligned across columns
    for i in range(16):
        j = np.where(b["rewards"] == s["rewards"][i])[0][0]
        assert np.allclose(b["obs"][j], s["obs"][i])


def test_split_by_episode():
    b = SampleBatch(obs=np.zeros((6, 2)), eps_id=np.array([1, 1, 2, 2, 2, 3]))
    eps = b.split_by_episode()
    assert [e.count for e in eps] == [2, 3, 1]
    want = JaxSampleBatch(dict(b.items())).split_by_episode()
    assert [e.count for e in eps] == [w.count for w in want]


def test_multi_agent_select_concat():
    ma = MultiAgentBatch({"p1": make_batch(4), "p2": make_batch(6)})
    assert ma.count == 10
    sel = ma.select(["p1"])
    assert list(sel.policy_batches) == ["p1"]
    merged = MultiAgentBatch.concat_samples([ma, ma])
    assert merged.count == 20
