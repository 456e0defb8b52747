"""The port's native library and partitioners against the JAX package's,
on the CPU.

The port builds its own copy of ``partitioner.cpp`` (g++ at first use,
into its gitignored build directory); its partitions, RCM orders and AMG
aggregates equal the JAX package's native ones and the numpy loops. The
partitioners (``LinearPartitioner``, ``MetisPartitioner`` with forced
groups, the quality gate that hands a degenerate native result to the
python grower) and ``partition_to_groups``, ``load_balance``,
``edge_cut`` equal the JAX package's. Without g++ the port raises where
the JAX package falls back.
"""

import numpy as np
import pytest

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu import native as jnative
from jutul.jl_tpu.parallel import partition as jpart
from jutul.jl_tpu_torch import native as tnative
from jutul.jl_tpu_torch.linsolve import amg as tamg
from jutul.jl_tpu_torch.parallel import partition as tpart


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _graph(dims=(10, 8, 4)):
    m = tpkg.UnstructuredMesh.from_cartesian(
        tpkg.CartesianMesh(dims, tuple(float(d) for d in dims)))
    return np.asarray(m.neighborship()), m.number_of_cells()


@pytest.mark.parametrize("n_blocks", [2, 5, 8, 16])
@pytest.mark.parametrize("weighted", [False, True])
def test_native_partition_and_rcm(n_blocks, weighted):
    nb, nc = _graph()
    w = np.random.default_rng(1).uniform(0.5, 2.0, nc) if weighted else None
    p = tnative.native_partition(nb, nc, n_blocks, w)
    assert _same(p, jnative.native_partition(nb, nc, n_blocks, w))
    assert np.bincount(p, minlength=n_blocks).min() > 0
    assert _same(tnative.native_rcm(nb, nc), jnative.native_rcm(nb, nc))


def test_native_aggregate_equals_loop():
    rng = np.random.default_rng(3)
    nb, nc = _graph((9, 7, 3))
    # an ELL sparsity: self first, then the neighbours, padded with self
    nbr = [[i] for i in range(nc)]
    for a, b in nb:
        nbr[a].append(b)
        nbr[b].append(a)
    S = max(len(r) for r in nbr)
    cols = np.array([r + [r[0]] * (S - len(r)) for r in nbr])
    perm = rng.permutation(nc)  # an unordered numbering too
    inv = np.argsort(perm)
    for c in (cols, inv[cols[perm]]):
        a = tnative.native_aggregate(c, nc)
        assert _same(a, tamg.greedy_aggregate_loop(c, nc))
        assert _same(a, jnative.native_aggregate(c, nc))
        assert _same(a, tamg.greedy_aggregate(c, nc))


def test_quality_gate_takes_the_python_grower():
    """A 320-cell mesh with heavy log-normal weights: the native result
    leaves a block empty, the gate hands the graph to the python grower
    in both packages."""
    nb, nc = _graph()
    w = np.random.default_rng(0).lognormal(0.0, 2.0, nc)
    k = 39
    p_native = tnative.native_partition(nb, nc, k, w)
    sizes = np.bincount(p_native, weights=w, minlength=k)
    assert sizes.min() == 0 or sizes.max() > 2.0 * sizes.sum() / k
    p = tpkg.MetisPartitioner().partition(nb, nc, k, weights=w)
    assert _same(p, jpkg.MetisPartitioner().partition(nb, nc, k, weights=w))
    assert _same(p, tpart.GreedyGraphPartitioner()._python_partition(
        nb, nc, k, w, None))
    assert not _same(p, p_native)


@pytest.mark.parametrize("groups", [None, [[5, 6, 7, 85, 165],
                                           [300, 301], [301, 2]]])
def test_partitioners(groups):
    nb, nc = _graph()
    w = np.random.default_rng(2).uniform(1.0, 3.0, nc)
    for name in ("LinearPartitioner", "GreedyGraphPartitioner",
                 "MetisPartitioner"):
        for weights in (None, w):
            pt = getattr(tpart, name)().partition(nb, nc, 6, weights, groups)
            pj = getattr(jpart, name)().partition(nb, nc, 6, weights, groups)
            assert _same(pt, pj), name
            # contraction keeps every group (overlapping ones merged) in
            # one block; the linear one's majority vote, one at a time
            for g in (groups or []) if name != "LinearPartitioner" else []:
                assert len(set(pt[np.asarray(g)])) == 1
            gt, gj = tpart.partition_to_groups(pt), \
                jpart.partition_to_groups(pj)
            assert len(gt) == len(gj) and all(map(_same, gt, gj))
            assert tpart.load_balance(pt, weights) == \
                jpart.load_balance(pj, weights)
            assert tpart.edge_cut(pt, nb) == jpart.edge_cut(pj, nb)


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    tnative.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tnative.native_rcm(*_graph((3, 2, 1)))
    finally:
        tnative.load_library.cache_clear()
