"""The port's top-level names against the JAX package's.

- Every public name of ``dir(jutul.jl_tpu)`` is importable from
  ``jutul.jl_tpu_torch`` and is listed in its ``__all__`` (a submodule
  is imported, not listed), as the same kind of object: module, class or
  function. ``JAX_ONLY`` would list, with its reason, a name the port
  leaves out; today it is empty.
- ``SourceTerm`` and ``setup_state_and_parameters``, the two with no
  counterpart before, on a 4x4 time-dependent Poisson case at f64: the
  same state and parameters from the same mixed keywords, the same
  residual contribution (a cell named twice adds up), and one report step
  of two ministeps through each package's default engine with the same
  counts and states within 1e-12.
"""

import inspect

import numpy as np
import pytest

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg

# name -> why the port leaves it out
JAX_ONLY: dict[str, str] = {}
PUBLIC = sorted(n for n in dir(jpkg) if not n.startswith("_"))


def _kind(obj):
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else type(obj).__name__


@pytest.mark.parametrize("name", PUBLIC)
def test_public_name_importable_from_the_port(name):
    if name in JAX_ONLY:
        assert not hasattr(tpkg, name), f"{name} is ported: drop JAX_ONLY"
        return
    assert hasattr(tpkg, name), f"jutul.jl_tpu_torch has no {name}"
    ours = getattr(tpkg, name)
    assert _kind(ours) == _kind(getattr(jpkg, name))
    if not inspect.ismodule(ours):
        assert name in tpkg.__all__


def _poisson(pkg):
    dd = pkg.DataDomain(pkg.CartesianMesh((4, 4), (1.0, 1.0)))
    dd.set("poisson_coefficient", np.linspace(1.0, 2.0, 16))
    return pkg.SimulationModel(dd, pkg.VariablePoissonSystem(
        time_dependent=True))


U0 = np.random.default_rng(7).random(16)
REG = np.full(16, 1e-3)


def test_setup_state_and_parameters_matches_the_jax_package():
    got = {}
    for pkg in (jpkg, tpkg):
        model = _poisson(pkg)
        got[pkg] = pkg.setup_state_and_parameters(
            model, {"U": U0}, PoissonRegularization=REG)
        with pytest.raises(ValueError, match="Unknown"):
            pkg.setup_state_and_parameters(model, U=U0, Q=1.0)
    for part_j, part_t in zip(got[jpkg], got[tpkg]):
        assert part_j.keys() == part_t.keys()
        for k in part_j:
            assert np.array_equal(np.asarray(part_j[k]), part_t[k]), k


def test_source_term_matches_the_jax_package():
    import torch

    cells, q = [3, 10, 3], [0.5, -1.0, 0.25]
    r0 = np.random.default_rng(8).random((16, 1))
    rj = jpkg.SourceTerm(np.array(cells), np.array(q)).apply(
        None, None, "poisson", jpkg.dtypes.jnp.asarray(r0), None, 1.0)
    rt = tpkg.SourceTerm(cells, q).apply(
        None, None, "poisson", torch.from_numpy(r0), None, 1.0)
    assert np.array_equal(np.asarray(rj), rt.numpy())
    want = r0.copy()
    want[3, 0] -= 0.75
    want[10, 0] += 1.0
    assert np.allclose(rt.numpy(), want, rtol=0, atol=1e-15)

    out = {}
    for pkg in (jpkg, tpkg):
        model = _poisson(pkg)
        state0, params = pkg.setup_state_and_parameters(
            model, U=U0, PoissonRegularization=REG)
        kw = {} if pkg is jpkg else dict(device="cpu")
        sim = pkg.Simulator(model, state0=state0, parameters=params,
                            use_stencil=False, **kw)
        out[pkg] = sim.simulate(
            [0.2], forces={"q": pkg.SourceTerm(np.array(cells),
                                               np.array(q)[:, None])},
            max_timestep=0.1, info_level=-1)
    counts = [[(m["iterations"], m["linear_iterations"], m["success"])
               for r in res.reports for m in r["ministeps"]]
              for res in (out[jpkg], out[tpkg])]
    assert counts[0] == counts[1] and len(counts[1]) == 2
    uj = np.asarray(out[jpkg].states[-1]["U"])
    ut = out[tpkg].states[-1]["U"]
    assert np.max(np.abs(ut - uj)) <= 1e-12 * np.max(np.abs(uj))
    assert not np.allclose(ut, U0)  # the sources moved the state
