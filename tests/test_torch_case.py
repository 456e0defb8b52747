"""The port's flagship case equals the JAX package's, exactly.

``chip_smoke.build_flagship`` (PyTorch port API) against bench.py
``build(..., gravity=True, wells=True, well_models=False)`` (JAX package):
geometry, transmissibilities, gravity differences, state0, parameters and
the source-term wells, compared with rtol=0. Also covers ``from_numpy``,
which carries the JAX package's dicts into the port.
"""

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from jutul.jl_tpu_torch.models.setup import from_numpy

DIMS = (16, 16, 8)


@pytest.fixture(scope="module")
def cases():
    jax_case = bench.build(*DIMS, gravity=True, wells=True, well_models=False)
    return jax_case, chip_smoke.build_flagship(*DIMS)


def test_geometry_identical(cases):
    (jmodel, *_), (tmodel, *_) = cases
    jg, tg = jmodel.data_domain.geometry, tmodel.data_domain.geometry
    for name in ("neighbors", "areas", "volumes", "normals",
                 "cell_centroids", "face_centroids", "boundary_neighbors",
                 "boundary_areas", "boundary_centroids"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name),
                                      err_msg=name)


@pytest.mark.parametrize("name", ["Transmissibilities",
                                  "GravityPotentialDifference",
                                  "FluidVolume"])
def test_parameters_identical(cases, name):
    (_, _, _, jparams, _), (_, _, tparams, _) = cases
    assert set(tparams) == set(jparams)
    np.testing.assert_allclose(tparams[name], np.asarray(jparams[name]),
                               rtol=0, atol=0)


def test_state0_and_forces_identical(cases):
    (_, _, jstate, _, jforces), (_, tstate, _, tforces) = cases
    assert set(tstate) == set(jstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k], np.asarray(jstate[k]),
                                   rtol=0, atol=0)
    np.testing.assert_array_equal(tforces["wells"].cells,
                                  jforces["wells"].cells)
    np.testing.assert_allclose(tforces["wells"].values,
                               np.asarray(jforces["wells"].values), rtol=0)


def test_from_numpy_carries_jax_dicts(cases):
    (_, _, jstate, jparams, _), _ = cases
    for d in (jstate, jparams):
        t64 = from_numpy(d, "cpu")
        t32 = from_numpy(d, "cpu", dtype=torch.float32)
        for k, v in d.items():
            assert t64[k].dtype == torch.float64
            assert t64[k].device.type == "cpu"
            np.testing.assert_array_equal(t64[k].numpy(), np.asarray(v))
            assert t32[k].dtype == torch.float32
            np.testing.assert_array_equal(
                t32[k].numpy(), np.asarray(v).astype(np.float32))


def test_cuda_device_raises_without_cuda(cases, monkeypatch):
    """Asking for the card where there is none raises, never falls back."""
    from jutul.jl_tpu_torch import Simulator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _, jstate, jparams, _), (tmodel, *_) = cases
    with pytest.raises(RuntimeError, match="cuda"):
        from_numpy(jstate, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulator(tmodel, jstate, jparams, device="cuda")


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device the entry points ask for the card: without one they
    raise and say how to ask for the CPU; ``device="cpu"`` runs."""
    import jutul.jl_tpu_torch as tpkg
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, state0, params, forces = chip_smoke.build_flagship(4, 4, 2)
    wmodel, *_ = chip_smoke.build_well_flagship(4, 4, 2)
    for call in (lambda: tpkg.Simulator(model, state0, params),
                 lambda: tpkg.simulate(state0, model, [60.0],
                                       parameters=params),
                 lambda: from_numpy(state0),
                 lambda: BorderedStencilModel(tpkg.compile_model(wmodel))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    sim = tpkg.Simulator(model, state0, params, device="cpu")
    assert sim.device.type == "cpu" and sim.dtype == torch.float64
    res = sim.simulate([60.0], forces=forces, info_level=-1)
    assert res.reports[0]["success"]
    assert np.all(np.isfinite(res.states[-1]["Pressure"]))
