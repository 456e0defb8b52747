"""The port's shard groups (``parallel/comm.py``) on the CPU.

- every collective of ``ShardGroup.threads(D)`` against numpy;
- psum combines in rank order: every shard holds the same bits;
- the halo exchanges of both engines (the slab planes, the general
  partition's all_to_all and ppermute rounds) and their explicit
  transposes hold the dot identity
  sum_shards <halo(x), y> = sum_shards <x, halo^T(y)>;
- a shard's exception is re-raised in the caller instead of hanging the
  others in a collective;
- ``ShardGroup.process_group`` over 2 gloo ranks (two processes) computes
  the same states and counts as ``threads(2)`` (within 1e-14) on the slab
  engine and on the general engine with both halo modes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu_torch.parallel.comm import ShardGroup

REPO = Path(__file__).resolve().parents[1]
BAR = 1e5
DARCY = 9.869232667160130e-13


def _run(D, body, args=None):
    return ShardGroup.threads(D, "cpu").run(body, args or [None] * D)


@pytest.mark.parametrize("D", [1, 3, 4])
def test_thread_collectives_match_numpy(D):
    rng = np.random.default_rng(D)
    xs = [rng.normal(size=(5, 2)) for _ in range(D)]
    a2a = [rng.normal(size=(D, 3)) for _ in range(D)]
    perm = [(i, (i + 1) % D) for i in range(D - 1)]

    def body(comm, d):
        x = torch.as_tensor(xs[d])
        return dict(
            rank=comm.axis_index(),
            psum=comm.psum(x), pmax=comm.pmax(x),
            gather=comm.all_gather(x),
            perm=comm.ppermute(x, perm),
            a2a=comm.all_to_all(torch.as_tensor(a2a[d])))

    outs = _run(D, body, list(range(D)))
    ref_sum = xs[0]
    for x in xs[1:]:
        ref_sum = ref_sum + x  # rank order
    for d, o in enumerate(outs):
        assert o["rank"] == d
        assert np.array_equal(o["psum"].numpy(), ref_sum)
        assert np.array_equal(o["pmax"].numpy(), np.max(xs, axis=0))
        assert np.array_equal(o["gather"].numpy(), np.concatenate(xs))
        src = [s for s, t in perm if t == d]
        want = xs[src[0]] if src else np.zeros_like(xs[d])
        assert np.array_equal(o["perm"].numpy(), want)
        assert np.array_equal(o["a2a"].numpy(),
                              np.stack([a2a[s][d] for s in range(D)]))


def test_psum_same_bits_on_every_shard():
    D = 4
    vals = [torch.tensor([0.1 * (d + 1), 1e16, -1e16 + d], dtype=torch.float64)
            for d in range(D)]
    outs = _run(D, lambda comm, d: comm.psum(vals[d]), list(range(D)))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    ref = vals[0]
    for v in vals[1:]:
        ref = ref + v
    assert torch.equal(outs[0], ref)


def test_worker_exception_is_reraised():
    def body(comm, d):
        if d == 1:
            raise ValueError("shard 1 fails")
        comm.psum(torch.ones(1))  # the others wait in a collective
        return d

    group = ShardGroup.threads(3, "cpu")
    with pytest.raises(ValueError, match="shard 1 fails"):
        group.run(body, [0, 1, 2])


def _slab_sim(D):
    from jutul.jl_tpu_torch.models.darcy import (ImmiscibleFluid,
                                                 ImmiscibleSystem)

    mesh = tpkg.CartesianMesh((3, 2, 8), (3.0, 2.0, 8.0))
    system = ImmiscibleSystem(ImmiscibleFluid(), gravity=False)
    nc = mesh.number_of_cells()
    return tpkg.DistributedSimulator(
        mesh, system, ShardGroup.threads(D, "cpu"),
        data_fields={"permeability": np.full(nc, DARCY),
                     "porosity": np.full(nc, 0.25)})


def _general_sim(D, halo_mode):
    from jutul.jl_tpu_torch.models.darcy import (ImmiscibleFluid,
                                                 ImmiscibleSystem)

    mesh = tpkg.UnstructuredMesh.from_cartesian(
        tpkg.CartesianMesh((5, 4, 3), (5.0, 4.0, 3.0)))
    nc = mesh.number_of_cells()
    system = ImmiscibleSystem(ImmiscibleFluid(), gravity=False)
    return tpkg.GeneralDistributedSimulator(
        mesh, system, ShardGroup.threads(D, "cpu"), halo_mode=halo_mode,
        data_fields={"permeability": np.full(nc, DARCY),
                     "porosity": np.full(nc, 0.25)})


@pytest.mark.parametrize("engine", ["slab", "all_to_all", "ppermute"])
def test_halo_transpose_dot_identity(engine):
    D = 4
    rng = np.random.default_rng(7)
    if engine == "slab":
        sim = _slab_sim(D)
        n_own, n_ext = sim.n_own, sim.dec.n_ext

        def halo(comm, x):
            return sim._halo_exchange(comm, x)

        def halo_T(comm, y):
            return sim._halo_transpose(comm, y)
    else:
        sim = _general_sim(D, engine)
        n_own, n_ext = sim.dec.n_own_max, sim.dec.n_loc

        def halo(comm, x):
            return sim._halo(comm, sim._shard(comm.rank), x)

        def halo_T(comm, y):
            return sim._halo_transpose(comm, sim._shard(comm.rank), y)
    xs = [torch.as_tensor(rng.normal(size=(n_own, 2))) for _ in range(D)]
    ys = [torch.as_tensor(rng.normal(size=(n_ext, 2))) for _ in range(D)]

    def body(comm, d):
        hx = halo(comm, xs[d])
        hty = halo_T(comm, ys[d])
        return torch.sum(hx * ys[d]), torch.sum(xs[d] * hty)

    outs = _run(D, body, list(range(D)))
    lhs = sum(float(o[0]) for o in outs)
    rhs = sum(float(o[1]) for o in outs)
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


_RANK_CODE = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
rank, kind = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method={init!r}, rank=rank,
                        world_size=2)
import chip_smoke
import jutul.jl_tpu_torch as T


def run(group):
    if kind == "slab":
        mesh, system, df, init, forces = chip_smoke.slab_case(T)
        sim = T.DistributedSimulator(mesh, system, group, data_fields=df,
                                     local_preconditioner="cpr")
        kw = {{}}
    else:
        mesh, system, df, init = chip_smoke.unstructured_dd_case(T)
        forces = {{"src": T.PhaseSourceTerm([0], np.array([[0.05, 0.0]]))}}
        sim = T.GeneralDistributedSimulator(mesh, system, group,
                                            halo_mode=kind, data_fields=df)
        kw = dict(preconditioner="cpr")
    return sim.simulate(sim.initial_state(**init), [4320.0, 8640.0],
                        forces=forces, tol_cnv=1e-10, max_newton=30,
                        info_level=-1, **kw)


s_pg, r_pg = run(T.ShardGroup.process_group())
if rank == 0:
    s_th, r_th = run(T.ShardGroup.threads(2, "cpu"))
    err = max(chip_smoke._state_rel(a, b) for a, b in zip(s_pg, s_th))
    np.savez({out!r}, err=err,
             same=chip_smoke._counts(r_pg) == chip_smoke._counts(r_th))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("kind", ["slab", "all_to_all", "ppermute"])
def test_process_group_gloo_matches_threads(kind, tmp_path):
    out = tmp_path / "out.npz"
    code = _RANK_CODE.format(repo=str(REPO),
                             init=(tmp_path / "init").as_uri(),
                             out=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), kind],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        results = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_o, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    res = np.load(out)
    assert bool(res["same"])
    assert float(res["err"]) <= 1e-14
