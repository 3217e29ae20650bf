"""Property tests of the port's stage fusion (``tests/test_fusion_properties.py``):
``fuse_for_each`` output is item-for-item equal to the unfused plan on
randomly generated for_each/filter/batch chains, fusion never adds a node,
and a pure chain fuses to one node."""

import pytest

pytest.importorskip("hypothesis", reason="property-based tests need hypothesis")
from hypothesis import given, settings, strategies as st

import repro_torch.flow as flow
from repro_torch.core.iterators import NextValueNotReady

# One chain element: ("map", k) pure stage, ("impure_map", k) unmarked stage,
# ("filter", m) predicate node, ("batch", n) stateful buffering stage.
ops_strategy = st.lists(
    st.one_of(
        st.tuples(st.just("map"), st.integers(min_value=-5, max_value=5)),
        st.tuples(st.just("impure_map"), st.integers(min_value=-5, max_value=5)),
        st.tuples(st.just("filter"), st.integers(min_value=2, max_value=4)),
        st.tuples(st.just("batch"), st.integers(min_value=1, max_value=3)),
    ),
    min_size=1,
    max_size=6,
)

items_strategy = st.lists(st.integers(min_value=-50, max_value=50), min_size=0, max_size=30)


def _batcher(n):
    buf = []

    def _batch(x):
        buf.append(x)
        if len(buf) < n:
            return NextValueNotReady()
        out, buf[:] = list(buf), []
        return out

    return _batch


def _as_scalar(x):
    # After batch stages items are (possibly nested) lists; fold them so
    # later integer stages still apply (keeps chains closed under
    # composition).
    if isinstance(x, list):
        return sum(_as_scalar(v) for v in x)
    return x


def build_spec(items, ops):
    spec = flow.FlowSpec("prop_chain")
    s = spec.from_items(list(items))
    for kind, arg in ops:
        if kind == "map":
            s = s.for_each(flow.pure(lambda x, _a=arg: _as_scalar(x) + _a), label=f"+{arg}")
        elif kind == "impure_map":
            s = s.for_each(lambda x, _a=arg: _as_scalar(x) * _a, label=f"*{arg}")
        elif kind == "filter":
            s = s.filter(lambda x, _m=arg: _as_scalar(x) % _m != 0)
        else:  # batch
            s = s.for_each(_batcher(arg), label=f"batch({arg})")
    spec.set_output(s)
    return spec


@given(items_strategy, ops_strategy)
@settings(max_examples=60, deadline=None)
def test_fused_equals_unfused_item_for_item(items, ops):
    fused = list(build_spec(items, ops).compile(fuse=True))
    unfused = list(build_spec(items, ops).compile(fuse=False))
    assert fused == unfused


@given(items_strategy, ops_strategy)
@settings(max_examples=40, deadline=None)
def test_fusion_never_increases_for_each_nodes(items, ops):
    spec = build_spec(items, ops)
    n_before = sum(n.kind == "for_each" for n in spec.nodes.values())
    opt = flow.fuse_for_each(spec)
    n_after = sum(n.kind == "for_each" for n in opt.nodes.values())
    assert n_after <= n_before
    # Fusion preserves total stage count.
    stages = lambda sp: sum(
        len(n.params["stages"]) for n in sp.nodes.values() if n.kind == "for_each"
    )
    assert stages(opt) == stages(spec)


@given(items_strategy, st.integers(min_value=1, max_value=5))
@settings(max_examples=30, deadline=None)
def test_pure_map_chain_fuses_to_single_node(items, depth):
    spec = flow.FlowSpec("pure_chain")
    s = spec.from_items(list(items))
    for i in range(depth):
        s = s.for_each(flow.pure(lambda x, _i=i: x + _i), label=f"s{i}")
    spec.set_output(s)
    opt = flow.fuse_for_each(spec)
    assert sum(n.kind == "for_each" for n in opt.nodes.values()) == 1
    expected = [x + sum(range(depth)) for x in items]
    assert list(spec.compile(fuse=True)) == expected
