"""``DistributedSimulator`` (the slab engine) of the port over
``ShardGroup.threads`` on the CPU at f64, against the JAX package's
``DistributedSimulator`` over fake devices, on tests/test_sharded.py's case
(``build_case(4, 3, 8)``, one water injector) over 2 and 4 shards with
block-Jacobi, RAS-ILU(0) and the distributed CPR: ministep and Newton
counts equal (linear its within 2 per Newton iteration: BiCGStab's
stopping test near the tolerance sees the packages' summation orders),
states within 1e-12 relative. The CPR run also against the port's single-device
``Simulator``.
"""

import numpy as np
import pytest

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from chip_smoke import slab_case
from test_torch_general_dd import assert_counts, assert_states

DAY = 86400.0


def _dmesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("d",))


def slab_pair(D, prec="block_jacobi", forces_of=None, dT=0.05 * DAY,
              smooth=False, **kw):
    """The slab case through both packages' solve_timestep: {pkg: (dsim,
    global final state, report)}. ``forces_of(pkg, dsim)`` builds the
    step's forces (default: the case's injector)."""
    out = {}
    for pkg in (jpkg, tpkg):
        mesh, system, df, init, forces = slab_case(pkg, smooth=smooth)
        group = _dmesh(D) if pkg is jpkg else tpkg.ShardGroup.threads(
            D, "cpu")
        dsim = pkg.DistributedSimulator(mesh, system, group, data_fields=df,
                                        local_preconditioner=prec)
        if forces_of is not None:
            forces = forces_of(pkg, dsim)
        s0 = dsim.shard_state(dsim.initial_state(**init))
        cur, _its = dsim.solve_timestep(s0, s0, dT, forces=forces, **kw)
        state = ({k: np.asarray(v) for k, v in cur.items()} if pkg is jpkg
                 else dsim.gather_state(cur))
        out[pkg] = (dsim, state, dsim.last_report)
    assert_counts([out[jpkg][2]], [out[tpkg][2]])
    assert_states(out[jpkg][1], out[tpkg][1])
    return out


@pytest.mark.parametrize("D,prec", [(2, "block_jacobi"), (4, "block_jacobi"),
                                    (2, "ilu0"), (4, "ilu0"), (2, "cpr"),
                                    (4, "cpr")])
def test_slab_matches_jax(D, prec):
    out = slab_pair(D, prec, tol_cnv=1e-10)
    if prec == "cpr" and D == 4:
        mesh, system, df, init, forces = slab_case(tpkg)
        dsim = out[tpkg][0]
        ref = tpkg.Simulator(dsim.global_model, dsim.initial_state(**init),
                             device="cpu").simulate(
            [0.05 * DAY], forces=forces, info_level=-1,
            tolerances={"default": 1e-10}, max_nonlinear_iterations=30)
        assert_states(ref.states[-1], out[tpkg][1], tol=1e-8)
