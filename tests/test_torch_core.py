"""The port's copies of the index-space core give the JAX package's
outputs: decompositions, load-balanced worlds, clusters, merge plans and
the chunk lists of all seven layout strategies, on a seeded sweep of
2-D and 3-D worlds."""

import pytest
from hypothesis import given, settings, strategies as st

import repro.core as jc
import repro_torch.core as tc
from repro_torch.interop import blocks_from_records

SWEEP = settings(max_examples=20, deadline=None, derandomize=True,
                 database=None)


@st.composite
def worlds(draw):
    ndim = draw(st.sampled_from([2, 3]))
    counts = [draw(st.integers(1, 4 if ndim == 3 else 6))
              for _ in range(ndim)]
    block = [draw(st.sampled_from([2, 4, 8])) for _ in range(ndim)]
    shape = tuple(c * b for c, b in zip(counts, block))
    procs = draw(st.integers(1, 6))
    seed = draw(st.integers(0, 2 ** 16))
    return shape, tuple(block), procs, seed


def _recs(blocks):
    return [(b.lo, b.hi, b.owner, b.block_id) for b in blocks]


def _world(shape, block, procs, seed):
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks(shape, block),
                                  num_procs=procs, seed=seed)
    return jb, blocks_from_records(_recs(jb))


def _clusters(clusters):
    return [(c.cuboid.lo, c.cuboid.hi, [m.block_id for m in c.members])
            for c in clusters]


@SWEEP
@given(worlds())
def test_decompositions_match(w):
    shape, block, procs, seed = w
    assert _recs(tc.uniform_grid_blocks(shape, block)) == \
        _recs(jc.uniform_grid_blocks(shape, block))
    jb, tb = _world(*w)
    assert _recs(tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, block), num_procs=procs,
        seed=seed)) == _recs(jb)
    scheme = tuple(min(3, s) for s in shape)     # uneven splits too
    assert _recs(tc.regular_decomposition(shape, scheme)) == \
        _recs(jc.regular_decomposition(shape, scheme))
    assert tc.bounding_box(tb).hi == jc.bounding_box(jb).hi
    assert tc.default_reorg_scheme(len(shape), global_shape=shape) == \
        jc.default_reorg_scheme(len(shape), global_shape=shape)


@SWEEP
@given(worlds())
def test_clusters_and_merge_plans_match(w):
    jb, tb = _world(*w)
    procs = w[2]
    jgroups = [[b for b in jb if b.owner == p] for p in range(procs)]
    tgroups = [[b for b in tb if b.owner == p] for p in range(procs)]
    jgroups = [g for g in jgroups if g]
    tgroups = [g for g in tgroups if g]
    assert [_clusters(c) for c in tc.cluster_blocks_many(tgroups)] == \
        [_clusters(c) for c in jc.clustering.cluster_blocks_many(jgroups)]
    for jg, tg in zip(jgroups, tgroups):
        assert _clusters(tc.cluster_blocks(tg)) == \
            _clusters(jc.cluster_blocks(jg))
        jp, tp = jc.build_merge_plan(jg), tc.build_merge_plan(tg)
        assert [(o.block_id, o.dst_index, o.dst_slices)
                for o in tp.copies] == \
            [(o.block_id, o.dst_index, o.dst_slices) for o in jp.copies]
        assert _clusters(tp.clusters) == _clusters(jp.clusters)


def _layout(lp):
    return (lp.strategy, lp.global_shape, lp.num_subfiles,
            lp.inter_process_moved, lp.intra_node_moved,
            [(c.chunk.lo, c.chunk.hi, [s.block_id for s in c.sources],
              c.writer, c.subfile) for c in lp.chunks])


@pytest.mark.parametrize("strategy", tc.STRATEGIES)
@SWEEP
@given(w=worlds())
def test_plan_layout_matches(strategy, w):
    jb, tb = _world(*w)
    procs = w[2]
    kw = dict(num_procs=procs, procs_per_node=2, num_stagers=3)
    assert _layout(tc.plan_layout(strategy, tb, **kw)) == \
        _layout(jc.plan_layout(strategy, jb, **kw))


def test_strategies_are_the_references():
    assert tc.STRATEGIES == jc.STRATEGIES
