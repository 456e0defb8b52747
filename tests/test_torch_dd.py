"""The distributed engines' host tables against the JAX package: equal
arrays from the same inputs.

- ``decompose_slabs`` and the slab tables (``local_to_global_cells``,
  ``local_face_values``, the per-shard parameter stacks, the adjoint's
  face localisation);
- ``parallel/dd.py``: ghost rings, subset meshes, submodels, substates,
  remapped forces, and a submodel's simulation on the CPU;
- ``GeneralDecomposition``: send/recv plans, ppermute rounds, face tables
  and ghost lists on the dryrun well-graph case (forced well groups) and
  on a 1-D WENO K-wide stencil, with the gathered parameter stacks;
- the general CPR's shard-local aggregation and coarse tables;
- ``WellGraphMesh.partition_groups``.
"""

import numpy as np
import pytest

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from chip_smoke import dryrun_case

DARCY = 9.869232667160130e-13


def _dmesh(D):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:D]), ("d",))


@pytest.mark.parametrize("dims,D", [((4, 3, 8), 2), ((4, 3, 8), 4),
                                    ((3, 2, 6), 3)])
def test_slab_tables_equal(dims, D):
    from jutul.jl_tpu.parallel import adjoint as ja
    from jutul.jl_tpu.parallel import slab as js
    from jutul.jl_tpu_torch.parallel import adjoint as ta
    from jutul.jl_tpu_torch.parallel import slab as ts

    jm = jpkg.CartesianMesh(dims, (10.0, 10.0, 10.0))
    tm = tpkg.CartesianMesh(dims, (10.0, 10.0, 10.0))
    jd, td = js.decompose_slabs(jm, D), ts.decompose_slabs(tm, D)
    for a in ("global_dims", "n_devices", "planes_per_shard", "plane_size",
              "n_own", "n_ext", "own_slice"):
        assert getattr(td, a) == getattr(jd, a), a
    assert np.array_equal(td.face_alive, jd.face_alive)
    assert np.array_equal(td.own_mask, jd.own_mask)
    assert np.array_equal(td.local_mesh.neighborship(),
                          jd.local_mesh.neighborship())
    rng = np.random.default_rng(0)
    gf = rng.normal(size=jm.number_of_faces())
    for d in range(D):
        assert np.array_equal(ts.local_to_global_cells(td, d),
                              js.local_to_global_cells(jd, d))
        assert np.array_equal(ts.local_face_values(td, d, gf, tm),
                              js.local_face_values(jd, d, gf, jm))
        assert np.array_equal(ta._local_face_indices(td, d, tm),
                              ja._local_face_indices(jd, d, jm))
    with pytest.raises(ValueError):
        ts.decompose_slabs(tm, 5)


def test_slab_parameter_stacks_equal():
    from jutul.jl_tpu.models.darcy import ImmiscibleFluid as JF
    from jutul.jl_tpu.models.darcy import ImmiscibleSystem as JS
    from jutul.jl_tpu.parallel.sharded import DistributedSimulator as JD
    from jutul.jl_tpu_torch.models.darcy import ImmiscibleFluid as TF
    from jutul.jl_tpu_torch.models.darcy import ImmiscibleSystem as TS

    nc = 4 * 3 * 8
    rng = np.random.default_rng(1)
    df = {"permeability": rng.uniform(0.5, 2, nc) * DARCY,
          "porosity": np.full(nc, 0.25)}
    jd = JD(jpkg.CartesianMesh((4, 3, 8), (10.0, 10.0, 10.0)),
            JS(JF(), gravity=True), _dmesh(4), data_fields=df)
    td = tpkg.DistributedSimulator(
        tpkg.CartesianMesh((4, 3, 8), (10.0, 10.0, 10.0)),
        TS(TF(), gravity=True), tpkg.ShardGroup.threads(4, "cpu"),
        data_fields=df)
    assert set(td.cell_params) == set(jd.cell_params)
    assert set(td.face_params) == set(jd.face_params)
    for k in jd.cell_params:
        np.testing.assert_allclose(td.cell_params[k], jd.cell_params[k],
                                   rtol=1e-15, atol=0)
    for k in jd.face_params:
        np.testing.assert_allclose(td.face_params[k], jd.face_params[k],
                                   rtol=1e-15, atol=0)
    assert np.array_equal(td.cell_alive, jd.cell_alive)


def test_subcells_and_submodels_equal():
    from jutul.jl_tpu.models.darcy import PhaseSourceTerm as JP
    from jutul.jl_tpu.parallel import dd as jdd
    from jutul.jl_tpu.parallel.partition import LinearPartitioner as JL
    from jutul.jl_tpu_torch.models.darcy import PhaseSourceTerm as TP
    from jutul.jl_tpu_torch.parallel import dd as tdd

    jm = jpkg.UnstructuredMesh.from_cartesian(
        jpkg.CartesianMesh((6, 5, 2), (6.0, 5.0, 2.0)))
    tm = tpkg.UnstructuredMesh.from_cartesian(
        tpkg.CartesianMesh((6, 5, 2), (6.0, 5.0, 2.0)))
    nb = np.asarray(jm.neighborship())
    nc = jm.number_of_cells()
    part = JL().partition(nb, nc, 3)
    for block in range(3):
        owned = np.flatnonzero(part == block)
        for buffer in (1, 2, 3):
            a = jdd.subcells_with_overlap(nb, owned, buffer)
            b = tdd.subcells_with_overlap(nb, owned, buffer)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    jmod = jpkg.SimulationModel(jpkg.DataDomain(jm), jpkg.SimpleHeatSystem())
    tmod = tpkg.SimulationModel(tpkg.DataDomain(tm), tpkg.SimpleHeatSystem())
    js = jdd.submodel(jmod, part, block=1, buffer=2)
    ts = tdd.submodel(tmod, part, block=1, buffer=2)
    jg, tg = js.extra["global_map"], ts.extra["global_map"]
    assert np.array_equal(jg.cells, tg.cells)
    assert np.array_equal(jg.cell_is_ghost, tg.cell_is_ghost)
    assert np.array_equal(jg.faces, tg.faces)
    assert jg.full_to_inner == tg.full_to_inner and jg.n_owned == tg.n_owned
    assert np.array_equal(js.domain.mesh.neighborship(),
                          ts.domain.mesh.neighborship())
    jgeo, tgeo = js.domain.geometry, ts.domain.geometry
    for a in ("areas", "volumes", "normals", "cell_centroids",
              "face_centroids"):
        assert np.array_equal(getattr(jgeo, a), getattr(tgeo, a)), a
    for name, (_e, arr) in js.data_domain.items():
        assert np.array_equal(np.asarray(arr),
                              np.asarray(ts.data_domain[name])), name
    T0 = np.linspace(0.0, 1.0, nc)
    a = jdd.substate({"T": T0, "c": 1.0}, jmod, js)
    b = tdd.substate({"T": T0, "c": 1.0}, tmod, ts)
    assert np.array_equal(a["T"], b["T"]) and b["c"] == 1.0
    q = np.array([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    cells = [int(tg.cells[0]), 0, int(tg.cells[-1])]
    fa = jdd.subforces({"s": JP(cells, q)}, js)["s"]
    fb = tdd.subforces({"s": TP(cells, q)}, ts)["s"]
    assert np.array_equal(np.asarray(fa.cells), np.asarray(fb.cells))
    assert np.array_equal(np.asarray(fa.values), np.asarray(fb.values))
    assert tdd.subforces(None, ts) is None


def test_submodel_simulation_matches_jax():
    from jutul.jl_tpu.parallel import dd as jdd
    from jutul.jl_tpu_torch.parallel import dd as tdd

    n = 16
    T0 = np.cos(np.pi * (np.arange(n) + 0.5) / n)
    part = np.array([0] * 8 + [1] * 8)
    out = []
    for pkg, dd, kw in ((jpkg, jdd, {}), (tpkg, tdd, dict(device="cpu"))):
        model = pkg.SimulationModel(pkg.DataDomain(
            pkg.CartesianMesh((n,), (1.0,))), pkg.SimpleHeatSystem())
        sub = dd.submodel(model, part, block=0, buffer=3)
        s0 = dd.substate(pkg.setup_state(model, T=T0), model, sub)
        states, _ = pkg.simulate(s0, sub, [1e-5], info_level=-1, **kw)
        out.append(np.asarray(states[-1]["T"]))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-12, atol=1e-14)


_GEN_TABLES = ("l2g", "own_alive", "face_g", "face_alive", "face_l",
               "face_r", "face_st", "row_plus", "row_minus", "send_idx",
               "recv_slot")


def _assert_general_equal(jd, td):
    for a in ("n_devices", "K", "n_own_max", "n_ghost_max", "nf_max",
              "n_loc", "dump", "halo_m"):
        assert getattr(td, a) == getattr(jd, a), a
    for a in _GEN_TABLES:
        assert np.array_equal(getattr(td, a), getattr(jd, a)), a
        assert getattr(td, a).dtype == getattr(jd, a).dtype, a
    for lj, lt in ((jd.own_lists, td.own_lists),
                   (jd.ghost_lists, td.ghost_lists)):
        assert len(lj) == len(lt)
        for x, y in zip(lj, lt):
            assert np.array_equal(x, y)
    assert len(td.halo_rounds) == len(jd.halo_rounds)
    for (pj, sj, rj), (pt, st, rt) in zip(jd.halo_rounds, td.halo_rounds):
        assert tuple(pj) == tuple(pt)
        assert np.array_equal(sj, st) and np.array_equal(rj, rt)


@pytest.mark.parametrize("D", [3, 8])
def test_general_decomposition_equal_dryrun(D):
    from jutul.jl_tpu.parallel.general import GeneralDecomposition as JGD
    from jutul.jl_tpu.parallel.general_cpr import GeneralCPRSetup as JCS
    from jutul.jl_tpu_torch.parallel.general import (
        GeneralDecomposition as TGD,
    )
    from jutul.jl_tpu_torch.parallel.general_cpr import (
        GeneralCPRSetup as TCS,
    )

    jc = dryrun_case(jpkg, D)
    tc = dryrun_case(tpkg, D)
    assert tc["groups"] == jc["groups"]
    assert np.array_equal(tc["part"], jc["part"])
    for grp in tc["groups"]:
        assert len(np.unique(tc["part"][grp])) == 1
    jd = JGD(jc["wmesh"], jc["part"], D)
    td = TGD(tc["wmesh"], tc["part"], D)
    _assert_general_equal(jd, td)
    rng = np.random.default_rng(2)
    gc = rng.normal(size=(tc["wmesh"].number_of_cells(), 2))
    gf = rng.normal(size=tc["wmesh"].number_of_faces())
    gi = rng.integers(0, 9, size=tc["wmesh"].number_of_faces())
    assert np.array_equal(td.gather_cells(gc, 1e-30),
                          jd.gather_cells(gc, 1e-30))
    assert np.array_equal(td.gather_faces(gf), jd.gather_faces(gf))
    assert np.array_equal(td.gather_faces(gi), jd.gather_faces(gi))
    sh = td.shard_cells(gc)
    assert np.array_equal(sh, jd.shard_cells(gc))
    assert np.array_equal(td.unshard_cells(sh), gc)
    # the distributed CPR's shard-local aggregation and coarse tables
    jcs, tcs = JCS(jd), TCS(td)
    assert tcs.n_coarse == jcs.n_coarse and tcs.garbage == jcs.garbage
    assert np.array_equal(tcs.cstruct.cols, jcs.cstruct.cols)
    for a in ("flat_plus", "flat_minus", "flat_diag", "aggG_own"):
        assert np.array_equal(getattr(tcs, a), getattr(jcs, a)), a
    assert tcs.hier.n_levels == len(jcs.hier.levels)


def test_general_decomposition_equal_weno_wide_stencil():
    from jutul.jl_tpu.models.transport import TransportSystem as JT
    from jutul.jl_tpu.parallel.general import GeneralDecomposition as JGD
    from jutul.jl_tpu.parallel.partition import (
        GreedyGraphPartitioner as JP,
    )
    from jutul.jl_tpu_torch.models.transport import TransportSystem as TT
    from jutul.jl_tpu_torch.parallel.general import (
        GeneralDecomposition as TGD,
    )

    n, D = 30, 4
    decs = []
    for pkg, system in ((jpkg, JT("weno")), (tpkg, TT("weno"))):
        mesh = pkg.CartesianMesh((n,), (1.0,))
        model = pkg.SimulationModel(pkg.DataDomain(mesh), system)
        con = [c for info in model.equations.values()
               for c in info.contributions(model)
               if hasattr(c, "stencil")][0]
        part = JP().partition(mesh.neighborship(), n, D)
        GD = JGD if pkg is jpkg else TGD
        decs.append(GD(mesh, part, D, stencil=np.asarray(con.stencil)))
    assert decs[0].K > 2
    _assert_general_equal(*decs)


def test_partition_groups_equal():
    jc = dryrun_case(jpkg, 4)
    tc = dryrun_case(tpkg, 4)
    assert tc["wmesh"].partition_groups() == jc["wmesh"].partition_groups()
    assert np.array_equal(tc["wmesh"].neighborship(),
                          jc["wmesh"].neighborship())
