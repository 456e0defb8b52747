"""The generic engine's adjoint on the 10x10x6 well model (5 well models,
rate and BHP controls, 2 report steps of 1.5 h with the rate ramp), at f64
on the CPU, against the JAX package's: the Transmissibilities, FluidVolume
and state0 gradients of ``solve_adjoint_sensitivities`` in the direct
branch and the Krylov branch (ILU(0)-BiCGStab on the transposed BlockELL,
λ at rtol 1e-14), ``_jit`` equal to the host loop bit for bit. The bar and
why it is not tighter: tests/test_torch_generic_adjoint.py.
"""

import numpy as np
import pytest

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu_torch.adjoint import gradients as tgrad
from test_torch_generic_adjoint import AdjointCase, assert_gradients, krylov


@pytest.fixture(scope="module")
def wells():
    return AdjointCase((10, 10, 6), well_models=True)


@pytest.mark.parametrize("branch", ["direct", "krylov"])
def test_well_model_gradients_match_jax(wells, branch):
    tm, _, tpr, _ = wells.t
    kw = {} if branch == "direct" else dict(linear_solver=krylov(tpkg))
    storage = tgrad.AdjointStorage(tm, tpr, device="cpu", **kw)
    host = wells.port_gradients(storage)
    want = wells.jax_gradients(**(
        {} if branch == "direct" else dict(linear_solver=krylov(jpkg))))
    assert_gradients(host, want, branch)
    jit = wells.port_gradients(storage, jit=True)
    for k in host:
        np.testing.assert_array_equal(jit[k], host[k])
    if branch == "krylov":
        assert storage.lambda_converged == [True] * 4
        # one BiCGStab run per step, the same in the host loop and _jit
        its = storage.lambda_iterations
        assert its[:2] == its[2:] and all(i > 0 for i in its)
