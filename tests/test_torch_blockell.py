"""The port's block-ELL format and small-block algebra against the JAX
package, on the CPU at f64.

Same inputs from a seeded numpy generator through both packages:
``ELLStructure.build`` gives equal ``cols``/``slots_for`` (and both raise
for a pair outside the pattern; ``transpose_idx`` for an unsymmetric one);
``matvec``, ``rmatvec``, ``transpose`` and ``to_dense`` of a two-phase
Darcy Jacobian agree within 1e-14 relative; the general ``block_inv`` for
3x3 and 4x4 blocks within 1e-13 (the port's batched Gauss-Jordan against
the JAX package's, one block per call); the fixed-order ``SegmentSumPlan``
against ``np.add.at`` and against itself, bitwise.
"""

import numpy as np
import pytest
import torch

from jutul.jl_tpu.ops import blockell as jbe
from jutul.jl_tpu.ops import smallmat as jsm
from jutul.jl_tpu_torch.ops import blockell as tbe
from jutul.jl_tpu_torch.ops import smallmat as tsm


def _edges(seed=0, n=40, m=120):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2))
    return n, np.concatenate([e, e[:, ::-1]])  # structurally symmetric


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def test_build_and_slots_for_equal():
    n, e = _edges()
    js, ts = jbe.ELLStructure.build(n, e), tbe.ELLStructure.build(n, e)
    assert ts.n_slots == js.n_slots
    assert np.array_equal(ts.cols, np.asarray(js.cols))
    rows, cols = e[:, 0], e[:, 1]
    assert np.array_equal(ts.slots_for(rows, cols), js.slots_for(rows, cols))
    diag = np.arange(n)
    assert np.array_equal(ts.slots_for(diag, diag), js.slots_for(diag, diag))
    absent = (np.array([0]), np.array([0]))
    while True:  # a pair the pattern does not hold
        r, c = np.random.default_rng(1).integers(0, n, 2)
        if r != c and c not in js.cols[r]:
            absent = (np.array([r]), np.array([c]))
            break
    with pytest.raises(KeyError):
        js.slots_for(*absent)
    with pytest.raises(KeyError):
        ts.slots_for(*absent)


def test_transpose_idx_equal_and_unsymmetric_raises():
    n, e = _edges(2)
    js, ts = jbe.ELLStructure.build(n, e), tbe.ELLStructure.build(n, e)
    assert np.array_equal(ts.transpose_idx(),
                          np.asarray(js.transpose_idx()))
    one_way = np.array([[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="structurally symmetric"):
        jbe.ELLStructure.build(4, one_way).transpose_idx()
    with pytest.raises(ValueError, match="structurally symmetric"):
        tbe.ELLStructure.build(4, one_way).transpose_idx()


@pytest.fixture(scope="module")
def darcy_jacobian():
    """A two-phase Darcy Jacobian (JAX package, 5x4x3 with gravity) as a
    JAX BlockELL and the port's BlockELL on the same numbers."""
    from jutul.jl_tpu import CartesianMesh, compile_model, setup_parameters
    from jutul.jl_tpu import setup_state
    from jutul.jl_tpu.models.darcy import ImmiscibleFluid, setup_darcy_model
    from jutul.jl_tpu.models.setup import merge_state

    rng = np.random.default_rng(3)
    mesh = CartesianMesh((5, 4, 3), (50.0, 40.0, 6.0))
    nc = 60
    model = setup_darcy_model(
        mesh, ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
        permeability=rng.lognormal(0, 1, nc) * 1e-13, porosity=0.2,
        gravity=True)
    comp = compile_model(model)
    sw = rng.uniform(0.1, 0.9, nc)
    state = comp.evaluate_secondaries(merge_state(
        setup_state(model, Pressure=1e7 + 1e5 * rng.normal(size=nc),
                    Saturations=np.stack([sw, 1 - sw], axis=1)),
        setup_parameters(model)))
    blocks = np.array(comp.jacobian_blocks(state, state, 1e4))
    Jj = jbe.BlockELL(comp.ell, blocks)
    ts = tbe.ELLStructure.build(
        nc, np.stack([np.repeat(np.arange(nc), comp.ell.n_slots),
                      np.asarray(comp.ell.cols).reshape(-1)], axis=1))
    assert np.array_equal(ts.cols, np.asarray(comp.ell.cols))
    Jt = tbe.BlockELL(ts, torch.from_numpy(blocks))
    return Jj, Jt


def test_matvec_rmatvec_transpose_dense(darcy_jacobian):
    Jj, Jt = darcy_jacobian
    n = Jt.blocks.shape[0]
    x = np.random.default_rng(4).normal(size=(n, 2))
    assert _rel(Jt.matvec(torch.from_numpy(x)), Jj.matvec(x)) < 1e-14
    assert _rel(Jt.rmatvec(torch.from_numpy(x)), Jj.rmatvec(x)) < 1e-14
    assert _rel(Jt.to_dense(), Jj.to_dense()) == 0.0
    assert _rel(Jt.transpose().blocks, Jj.transpose().blocks) == 0.0
    dense = Jt.to_dense().numpy()
    assert _rel(Jt.rmatvec(torch.from_numpy(x)).reshape(-1),
                dense.T @ x.reshape(-1)) < 1e-14


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_block_inv_general(b):
    rng = np.random.default_rng(b)
    A = rng.normal(size=(50, b, b)) + 3.0 * b * np.eye(b)
    inv_t = tsm.block_inv(torch.from_numpy(A)).numpy()
    # one block per call on the JAX side: its Gauss-Jordan branch (b > 3)
    # broadcasts its row mask against unbatched blocks only
    ref = np.stack([np.asarray(jsm.block_inv(a)) for a in A])
    assert _rel(inv_t, ref) < 1e-13
    assert _rel(inv_t @ A, np.broadcast_to(np.eye(b), A.shape)) < 1e-13
    x = rng.normal(size=(50, b))
    assert _rel(tsm.block_solve(torch.from_numpy(A), torch.from_numpy(x)),
                np.einsum("nij,nj->ni", ref, x)) < 1e-13
    assert _rel(tsm.bmm(torch.from_numpy(A), torch.from_numpy(A)),
                jsm.bmm(A, A)) < 1e-14


def test_segment_sum_plan_fixed_order():
    rng = np.random.default_rng(6)
    dest = rng.integers(0, 37, size=500)
    dest[:40] = 5  # one wide destination
    data = rng.normal(size=(500, 3))
    plan = tbe.SegmentSumPlan(dest, 40)
    got = plan.apply(torch.from_numpy(data))
    ref = np.zeros((40, 3))
    np.add.at(ref, dest, data)
    assert _rel(got, ref) < 1e-14
    assert torch.equal(got, plan.apply(torch.from_numpy(data)))
