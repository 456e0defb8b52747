"""Smoke run of the PyTorch/CUDA port (jutul/jl_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It needs no arguments, no network and no JAX. Phases, each raising on
failure (nothing is caught, so any failure exits non-zero):

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: nvcc builds csrc/*.cu for sm_90a (timed);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the flagships' shapes, in float32 and float64, with times from CUDA
   events — of eager calls, and of the kernel's device work alone in a
   CUDA-graph replay (K1 block-stencil SpMV, K2 Jacobi/residual pass on every GMG
   level, K3 Darcy flux + Jacobian on every axis incl. cells at S=0, S=1,
   K4 Chebyshev step — every mode and the 2- and 12-step level hooks — on
   every GMG level of the well-model flagship's pressure hierarchy);
4. warm-up: both slices at 16x16x8 on the card (first use of each op);
   source-term slice: the bench flagship with source-term wells at
   256x64x64 = 1,048,576 cells in float32 through
   ``Simulator(use_stencil=True, device="cuda").simulate`` with the bench's
   solver settings (Jacobi GMG), 3 report steps of 6 h; K1, K2 and K3 must
   launch in this run and the final state be finite;
5. its f64 verify: the final accepted ministep's residual re-assembled in
   float64 on the card; CNV and MB within 10x their tolerances;
6. wells slice: the bench flagship with its 5 well models (1,048,576
   lattice + 5 wellbore cells, bordered stencil + Schur-eliminated wells)
   with the Chebyshev GMG smoother, otherwise as phase 4; K1, K2 (the
   residual after a Chebyshev presmooth), K3 and K4 must launch;
7. its f64 verify over all lattice and wellbore rows, as phase 5;
8. cross-checks: each slice on a small grid in float64 on the card
   (kernels) against the CPU (plain versions): identical ministep, Newton
   and linear-iteration counts, states within 1e-9.

Launch counts are set to 0 just before each slice and read just after it.
Output: progress lines, then one JSON line with every kernel's errors,
times and launches (``launches``: the wells slice; ``launches_srcwells``:
the source-term slice), then the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

GRID = (256, 64, 64)  # (nx, ny, nz), the bench flagship's 1,048,576 cells
SMALL = (16, 16, 8)  # source-term cross-check
# well-model cross-check: at 16x16x8 the well case's counts depend on
# roundoff (the JAX package's own Schur forms take 53, 57 or 54 linear
# iterations in its second ministep there, and the card's FMAs give 53
# against the CPU's 54); at 10x10x6 they do not
WELL_SMALL = (10, 10, 6)
DT = 6 * 3600.0
CNV_TOL, MB_TOL = 1e-3, 1e-6
# kernel vs plain, max |kernel - plain| / max |plain| per output: float32
# carries ~1e-7 per rounding over up to a few hundred roundings (12 Jacobi
# sweeps; the flux chain's exp/pow/cancellation); float64 the same at 2e-16
REL_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
KERNEL_INFO = {
    "stencil_matvec": ("jutul/jl_tpu_torch/csrc/stencil_kernels.cu",
                       "jutul/jl_tpu/ops/pallas/stencil_kernels.py:83"),
    "scalar_jacobi": ("jutul/jl_tpu_torch/csrc/stencil_kernels.cu",
                      "jutul/jl_tpu/ops/pallas/stencil_kernels.py:555"),
    "darcy_flux_jacobian": ("jutul/jl_tpu_torch/csrc/assembly_kernels.cu",
                            "jutul/jl_tpu/ops/pallas/assembly_kernels.py:57"),
    "scalar_chebyshev": (
        "jutul/jl_tpu_torch/csrc/stencil_kernels.cu",
        "jutul/jl_tpu/ops/pallas/stencil_kernels.py:431 (B6 "
        "_kernel_sweeps_cheby) and :716 (B7 _kernel_slab_sweeps_cheby)"),
}
SLICE_KERNELS = {  # kernels each slice must launch
    "srcwells": ("stencil_matvec", "scalar_jacobi", "darcy_flux_jacobian"),
    "wells": tuple(KERNEL_INFO),
}


def build_flagship(nx, ny, nz):
    """The bench flagship with its wells as source terms, through the
    port's API: a copy of bench.py ``build(nx, ny, nz, gravity=True,
    wells=True, well_models=False)`` — SPE10-style lognormal permeability,
    gravity on, 4 bottom-corner water injectors and 1 top-centre
    producer. Returns (model, state0, parameters, forces); state0 and
    parameters are host numpy dicts."""
    from jutul.jl_tpu_torch import (
        CartesianMesh,
        ImmiscibleFluid,
        PhaseSourceTerm,
        setup_darcy_model,
        setup_parameters,
        setup_state,
        si_unit,
    )

    BAR = si_unit("bar")
    DARCY = si_unit("darcy")
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny, nz), (100.0 * nx / 128, 100.0 * ny / 128,
                                        10.0 * nz / 64))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    perm = rng.lognormal(0.0, 1.0, nc) * 0.1 * DARCY
    sw = rng.uniform(0.2, 0.8, nc)
    # near-equilibrium initial pressure: hydrostatic down z plus a smooth
    # lateral field
    geo = mesh.tpfv_geometry()
    z = geo.cell_centroids[:, 2]
    x, y = geo.cell_centroids[:, 0], geo.cell_centroids[:, 1]
    Lx = 100.0 * nx / 128
    p0 = (200.0 * BAR - 1000.0 * 9.80665 * z
          + 2.0 * BAR * np.sin(2 * np.pi * x / Lx) * np.cos(np.pi * y / Lx))

    def cell(ix, iy, iz):
        return (iz * ny + iy) * nx + ix

    cell_vol = (100.0 / 128) ** 2 * (10.0 / 64)
    pore_mass = cell_vol * 0.25 * 1000.0  # kg of water per cell
    q = 0.2 * pore_mass / 21600.0  # kg/s per injector
    model = setup_darcy_model(mesh, fluid, permeability=perm, porosity=0.25,
                              gravity=True)
    state0 = setup_state(model, Pressure=p0,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    params = setup_parameters(model)
    cells = [cell(1, 1, nz - 1), cell(nx - 2, 1, nz - 1),
             cell(1, ny - 2, nz - 1), cell(nx - 2, ny - 2, nz - 1),
             cell(nx // 2, ny // 2, 0)]
    rates = np.array([[q, 0.0]] * 4 + [[-0.4 * q, -0.4 * q]])
    forces = {"wells": PhaseSourceTerm(cells, rates)}
    return model, state0, params, forces


def build_well_flagship(nx, ny, nz):
    """The bench flagship with its 5 well models, through the port's API:
    a copy of bench.py ``build(nx, ny, nz, gravity=True, wells=True,
    well_models=True)`` — the same reservoir as ``build_flagship`` plus 4
    rate-controlled injectors perforating the bottom layers and 1
    BHP-controlled producer perforating the top layers (up to 8
    completions each) as wellbore cells of a WellGraphMesh. Returns
    (model, state0, parameters, forces); state0 and parameters are host
    numpy dicts."""
    from jutul.jl_tpu_torch import (
        CartesianMesh,
        ImmiscibleFluid,
        PhaseSourceTerm,
        PressureBoundaryCondition,
        WellSpec,
        setup_state,
        setup_well_graph_model,
        si_unit,
    )

    BAR = si_unit("bar")
    DARCY = si_unit("darcy")
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny, nz), (100.0 * nx / 128, 100.0 * ny / 128,
                                        10.0 * nz / 64))
    fluid = ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    perm = rng.lognormal(0.0, 1.0, nc) * 0.1 * DARCY
    sw = rng.uniform(0.2, 0.8, nc)
    geo = mesh.tpfv_geometry()
    z = geo.cell_centroids[:, 2]
    x, y = geo.cell_centroids[:, 0], geo.cell_centroids[:, 1]
    Lx = 100.0 * nx / 128
    p0 = (200.0 * BAR - 1000.0 * 9.80665 * z
          + 2.0 * BAR * np.sin(2 * np.pi * x / Lx) * np.cos(np.pi * y / Lx))

    def cell(ix, iy, iz):
        return (iz * ny + iy) * nx + ix

    cell_vol = (100.0 / 128) ** 2 * (10.0 / 64)
    pore_mass = cell_vol * 0.25 * 1000.0  # kg of water per cell
    q = 0.2 * pore_mass / 21600.0  # kg/s per injector
    ncomp = min(8, nz)
    inj_cols = [(1, 1), (nx - 2, 1), (1, ny - 2), (nx - 2, ny - 2)]
    WI = 2.5e-13  # Peaceman-style, ~ an interior face transmissibility
    specs = [WellSpec(f"inj{i}",
                      [cell(ix, iy, nz - 1 - k) for k in range(ncomp)],
                      WI=WI, volume=1.0)
             for i, (ix, iy) in enumerate(inj_cols)]
    specs.append(WellSpec(
        "prod", [cell(nx // 2, ny // 2, k) for k in range(ncomp)],
        WI=WI, volume=1.0))
    model, wmesh, params = setup_well_graph_model(
        mesh, fluid, specs, permeability=perm, porosity=0.25, gravity=True)
    # wellbore initial state: completion-top pressure; injectors start
    # water-filled, the producer at the completion saturation
    pw = np.array([p0[s.cells[0]] for s in specs])
    sww = np.array([1.0] * 4 + [float(sw[specs[-1].cells[0]])])
    state0 = setup_state(
        model, Pressure=np.concatenate([p0, pw]),
        Saturations=np.stack([np.concatenate([sw, sww]),
                              np.concatenate([1 - sw, 1 - sww])], axis=1))
    inj_cells = [wmesh.well_cells[f"inj{i}"] for i in range(4)]
    bhp = float(p0[specs[-1].cells[0]]) - 2.0 * BAR
    forces = {
        # rate control: surface water stream into each injector
        "rate": PhaseSourceTerm(inj_cells, np.array([[q, 0.0]] * 4)),
        # BHP control: fixed-pressure surface connection whose control
        # transmissibility (10x the completions' WI) dominates the row
        "bhp": PressureBoundaryCondition(
            [wmesh.well_cells["prod"]], bhp, 10.0 * WI * ncomp,
            saturations=[0.5, 0.5]),
    }
    return model, state0, params, forces


def rate_schedule(forces, n_step):
    """Per-report-step forces with the bench's rate ramp (bench.py:570-579):
    the rates (key ``"rate"`` with well models, ``"wells"`` with
    source-term wells) scale 0.75x -> 1.25x across the report steps; every
    other force (the BHP producer) stays as it is."""
    key = "rate" if "rate" in forces else "wells"
    src = forces[key]
    base = np.asarray(src.values)
    return [{**forces, key: type(src)(
        src.cells, base * (0.75 + 0.5 * i / (n_step - 1)))}
        for i in range(n_step)]


def sim_config(min_cells, smoother="jacobi"):
    """The bench product path's solver and Newton settings
    (bench.py:528-601) with eager semantics."""
    from jutul.jl_tpu_torch import (
        GMG,
        IterationTimestepSelector,
        StencilCPR,
        StencilKrylovSolver,
        TimestepSelector,
    )

    return dict(
        linear_solver=StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=GMG(
                n_smooth=2, n_coarse_sweeps=12, min_cells=min_cells,
                smoother=smoother)),
            rtol=1e-3, max_iterations=25),
        tolerances={"mass_conservation/CNV": CNV_TOL,
                    "mass_conservation/MB": MB_TOL},
        max_nonlinear_iterations=12, tol_factor_final_iteration=10.0,
        timestep_selectors=[TimestepSelector(initial_fraction=0.25),
                            IterationTimestepSelector(target_iterations=6)],
        output_variables="primary", info_level=-1)


def log(msg):
    print(msg, flush=True)


def rel_err(kernel, plain):
    scale = float(plain.abs().max())
    return float((kernel - plain).abs().max()) / (scale if scale else 1.0)


def cuda_ms(fn, reps=20):
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Mean milliseconds per call of ``fn``'s device work alone: ``reps``
    calls captured in one CUDA graph, whose replay is timed with CUDA
    events. ``cuda_ms`` of a wrapper that launches one short kernel
    measures the host's launch rate instead (the wrapper's Python and
    ctypes time exceeds the kernel's)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # capture needs the wrapper's first-call work done
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    ms = cuda_ms(g.replay, reps=5) / reps
    del g
    torch.cuda.empty_cache()
    return ms


class KernelRecord:
    """Worst errors and the flagship-shape times of one kernel."""

    def __init__(self):
        self.max_abs = {}
        self.max_rel = {}
        self.ms = self.plain_ms = self.graph_ms = None

    def compare(self, dtype, what, kernel, plain):
        torch.cuda.synchronize()
        if not bool(torch.isfinite(kernel).all()):
            raise RuntimeError(f"{what}: kernel output not finite")
        rel = rel_err(kernel, plain)
        key = str(dtype).split(".")[-1]
        self.max_rel[key] = max(self.max_rel.get(key, 0.0), rel)
        self.max_abs[key] = max(self.max_abs.get(key, 0.0),
                                float((kernel - plain).abs().max()))
        log(f"  {what} [{key}]: max rel err {rel:.3e}")
        if not rel <= REL_TOL[dtype]:
            raise RuntimeError(f"{what} [{key}]: kernel disagrees with plain "
                               f"version: {rel:.3e} > {REL_TOL[dtype]:.0e}")


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"# device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}); {smi}")
    return smi


def phase_build():
    from jutul.jl_tpu_torch.ops.cuda._build import load_library

    t0 = time.perf_counter()
    lib = load_library()
    log(f"# build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{lib.build_seconds:.1f} s) -> {lib.path.name}")
    print(lib.compiler_log, file=sys.stderr, flush=True)


def _flagship_state(model, state0, params, dtype):
    """Flagship state on the card with cells on both clip bounds: every
    97th cell at S_w = 0, every 89th at S_w = 1."""
    from jutul.jl_tpu_torch import from_numpy

    st = dict(state0)
    s = st["Saturations"].copy()
    s[::97] = (0.0, 1.0)
    s[::89] = (1.0, 0.0)
    st["Saturations"] = s
    return (from_numpy(st, "cuda", dtype), from_numpy(params, "cuda", dtype))


def phase_kernels(case, records):
    from jutul.jl_tpu_torch import compile_model
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import assembly_kernels as AK
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
    from jutul.jl_tpu_torch.ops.stencil import (
        GMG,
        StencilCompiledModel,
        StencilCPR,
        StencilMatrix,
    )

    model, state0, params, _ = case
    comp = compile_model(model)
    sc = StencilCompiledModel(comp)
    L = sc.L
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.float64):
        log(f"# kernels vs plain, {dtype}, L={L}")
        st, pr = _flagship_state(model, state0, params, dtype)
        full = comp.evaluate_secondaries(merge_state(st, pr))
        U = comp.get_dofs(full).contiguous()
        faces = comp._face_entries(full)
        rec = records["darcy_flux_jacobian"]
        calls = []
        for a in range(3):
            fs = sc._axis_face_state(faces, a)
            args = (sc.form, U, *(fs[nm] for nm in sc.form.face_params),
                    L, a)
            rec.compare(dtype, f"K3 axis {a}", AK.darcy_flux_jacobian(*args),
                        AK.darcy_flux_jacobian_plain(*args))
            calls.append(args)
        if dtype == torch.float32:
            rec.ms = cuda_ms(
                lambda: [AK.darcy_flux_jacobian(*c) for c in calls])
            rec.graph_ms = graph_ms(
                lambda: [AK.darcy_flux_jacobian(*c) for c in calls])
            rec.plain_ms = cuda_ms(
                lambda: [AK.darcy_flux_jacobian_plain(*c) for c in calls])

        _, A, _ = sc.assemble(merge_state(st, pr), merge_state(st, pr), DT)
        rec = records["stencil_matvec"]
        col = StencilMatrix(L, A.diag[:, :1],
                            {a: v[:, :1] for a, v in A.plus.items()},
                            {a: v[:, :1] for a, v in A.minus.items()})
        for M, C, K, tag in ((A, 2, 2, "mv_A C=K=2"),
                             (col, 2, 1, "mv_Ap C=2,K=1")):
            mv = SK.StencilMatvec(M)
            x = torch.randn((A.n, K), generator=gen, device="cuda",
                            dtype=dtype)
            rec.compare(dtype, f"K1 {tag}", mv(x),
                        SK.stencil_matvec_plain(mv.coef, x, L, C, K))
            if dtype == torch.float32 and K == 2:
                rec.ms = cuda_ms(lambda: mv(x))
                rec.graph_ms = graph_ms(lambda: mv(x))
                rec.plain_ms = cuda_ms(
                    lambda: SK.stencil_matvec_plain(mv.coef, x, L, C, K))

        rec = records["scalar_jacobi"]
        cpr = StencilCPR(gmg=GMG(n_smooth=2, n_coarse_sweeps=12,
                                 min_cells=16384))
        pst = cpr.update(A)
        om = cpr.gmg.omega
        for lv in pst.mvs:
            n = int(np.prod(lv.L))
            b = torch.randn(n, generator=gen, device="cuda", dtype=dtype)
            u = torch.randn(n, generator=gen, device="cuda", dtype=dtype)

            def plain(b_, u_, n_sweep, init_zero, emit_residual):
                P = lambda bb, uu, mode: SK.scalar_jacobi_plain(  # noqa: E731
                    lv.coef, bb, uu, om, mode, lv.L)
                uu = P(b_, None, SK.MODE_INIT) if init_zero else u_
                for _ in range(n_sweep - 1 if init_zero else n_sweep):
                    uu = P(b_, uu, SK.MODE_SMOOTH)
                return uu, (P(b_, uu, SK.MODE_RESIDUAL) if emit_residual
                            else None)

            for mode in (SK.MODE_INIT, SK.MODE_RESIDUAL, SK.MODE_SMOOTH):
                rec.compare(dtype, f"K2 {lv.L} mode {mode}",
                            SK.scalar_jacobi(lv.coef, b, u, om, mode, lv.L),
                            SK.scalar_jacobi_plain(lv.coef, b, u, om, mode,
                                                   lv.L))
            for n_sweep in (2, 12):
                uk, rk = lv.presmooth_residual(b, om, n_sweep)
                up, rp = plain(b, None, n_sweep, True, True)
                rec.compare(dtype, f"K2 {lv.L} presmooth+residual x{n_sweep}",
                            torch.stack([uk, rk]), torch.stack([up, rp]))
                rec.compare(dtype, f"K2 {lv.L} postsmooth x{n_sweep}",
                            lv.postsmooth(u, b, om, n_sweep),
                            plain(b, u, n_sweep, False, False)[0])
                rec.compare(dtype, f"K2 {lv.L} sweep_n x{n_sweep}",
                            lv.sweep_n(b, om, n_sweep),
                            plain(b, None, n_sweep, True, False)[0])
            if dtype == torch.float32 and lv is pst.mvs[0]:
                rec.ms = cuda_ms(lambda: lv.smooth(u, b, om))
                rec.graph_ms = graph_ms(lambda: lv.smooth(u, b, om))
                rec.plain_ms = cuda_ms(lambda: SK.scalar_jacobi_plain(
                    lv.coef, b, u, om, SK.MODE_SMOOTH, lv.L))
        del A, pst
        torch.cuda.empty_cache()


def phase_kernels_cheby(case, records):
    """K4 against its plain version on every GMG level of the well-model
    flagship's pressure hierarchy (the Chebyshev slice's levels): every
    mode, and the level hooks at 2 and 12 steps."""
    from jutul.jl_tpu_torch import compile_model, from_numpy
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
    from jutul.jl_tpu_torch.ops.stencil import GMG, StencilCPR
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    model, state0, params, forces = case
    eng = BorderedStencilModel(compile_model(model), "cuda")
    rec = records["scalar_chebyshev"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.float32, torch.float64):
        full = merge_state(from_numpy(state0, "cuda", dtype),
                           from_numpy(params, "cuda", dtype))
        _, B, _ = eng.assemble(full, full, DT, forces)
        pst = StencilCPR(gmg=GMG(n_smooth=2, n_coarse_sweeps=12,
                                 min_cells=16384,
                                 smoother="chebyshev")).update(B.A)
        log(f"# K4 vs plain, {dtype}, levels {[lv.L for lv in pst.mvs]}")
        for lv, steps in zip(pst.mvs, pst.cheb):
            n = int(np.prod(lv.L))
            b, u, d = (torch.randn(n, generator=gen, device="cuda",
                                   dtype=dtype) for _ in range(3))

            def step(fn, u_, d_, k, mode):
                return fn(lv.coef, b, u_, d_, steps, k, mode, lv.L)

            def plain(u_, n_sweep):
                mode = SK.CHEB_ZERO if u_ is None else SK.CHEB_FIRST
                uu, dd = step(SK.scalar_chebyshev_plain, u_, None, 0, mode)
                for k in range(1, n_sweep):
                    uu, dd = step(SK.scalar_chebyshev_plain, uu, dd, k,
                                  SK.CHEB_STEP)
                return uu

            for mode, k in ((SK.CHEB_ZERO, 0), (SK.CHEB_FIRST, 0),
                            (SK.CHEB_STEP, 1), (SK.CHEB_STEP, 11)):
                rec.compare(dtype, f"K4 {lv.L} mode {mode} step {k}",
                            torch.stack(step(SK.scalar_chebyshev, u, d, k,
                                             mode)),
                            torch.stack(step(SK.scalar_chebyshev_plain, u, d,
                                             k, mode)))
            for n_sweep in (2, 12):
                uk, rk = lv.presmooth_residual_cheby(b, steps, n_sweep)
                up = plain(None, n_sweep)
                rp = SK.scalar_jacobi_plain(lv.coef, b, up, 0.0,
                                            SK.MODE_RESIDUAL, lv.L)
                rec.compare(dtype, f"K4 {lv.L} presmooth+residual x{n_sweep}",
                            torch.stack([uk, rk]), torch.stack([up, rp]))
                rec.compare(dtype, f"K4 {lv.L} postsmooth x{n_sweep}",
                            lv.postsmooth_cheby(u, b, steps, n_sweep),
                            plain(u, n_sweep))
                rec.compare(dtype, f"K4 {lv.L} sweep_n x{n_sweep}",
                            lv.sweep_n_cheby(b, steps, n_sweep),
                            plain(None, n_sweep))
            if dtype == torch.float32 and lv is pst.mvs[0]:
                rec.ms = cuda_ms(lambda: step(SK.scalar_chebyshev, u, d, 1,
                                              SK.CHEB_STEP))
                rec.graph_ms = graph_ms(lambda: step(
                    SK.scalar_chebyshev, u, d, 1, SK.CHEB_STEP))
                rec.plain_ms = cuda_ms(lambda: step(
                    SK.scalar_chebyshev_plain, u, d, 1, SK.CHEB_STEP))
        del B, pst
        torch.cuda.empty_cache()


def phase_warm_up():
    """Both slices at 16x16x8 in float32 on the card, 2 report steps: the
    first use of each PyTorch op in a process loads its CUDA module
    (~12 s for the wells path), which the timed slices should not
    measure."""
    from jutul.jl_tpu_torch import Simulator

    t0 = time.perf_counter()
    for build, smoother in ((build_flagship, "jacobi"),
                            (build_well_flagship, "chebyshev")):
        model, state0, params, forces = build(*SMALL)
        Simulator(model, state0, params, device="cuda").simulate(
            [DT] * 2, forces=rate_schedule(forces, 2),
            **sim_config(64, smoother))
    torch.cuda.synchronize()
    log(f"# warm-up (both slices at 16x16x8): "
        f"{time.perf_counter() - t0:.1f} s")


def phase_slice(case, name, smoother):
    """One slice at full size in float32, 3 report steps; the kernels of
    ``SLICE_KERNELS[name]`` must launch in it."""
    from jutul.jl_tpu_torch import Simulator, report_stats
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, params, forces = case
    nc = model.number_of_cells()
    sim = Simulator(model, state0, params, use_stencil=True, device="cuda")
    schedule = rate_schedule(forces, 3)
    cfg = sim_config(16384, smoother)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.simulate([DT] * 3, forces=schedule, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    stats = report_stats(res.reports)
    peak = torch.cuda.max_memory_allocated()
    if not all(r["success"] for r in res.reports) or len(res.reports) != 3:
        raise RuntimeError(f"{name} slice: a report step failed")
    for k, v in res.states[-1].items():
        if not np.all(np.isfinite(v)):
            raise RuntimeError(f"{name} slice: final {k} not finite")
    missing = [k for k in SLICE_KERNELS[name] if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{name} slice: {missing} never launched: "
                           f"{launches}")
    newtons, lin = stats["newtons"], stats["linear_iterations"]
    out = {
        "slice": name, "smoother": smoother, "cells": nc,
        "dtype": "float32", "report_steps": 3,
        "ministeps": stats["ministeps"], "newtons": newtons,
        "failed_ministeps": stats["failed_ministeps"],
        "linear_iterations": lin,
        "wall_s": wall, "s_per_newton": wall / newtons,
        "cell_newton_its_per_s": nc * newtons / wall,
        "peak_mem_bytes": peak, "launches": launches,
        "launches_per_linear_iteration": {
            k: v / max(lin, 1) for k, v in launches.items()},
        # (Newtons, linear iterations) of each ministep: a ministep held at
        # the Newton cap shows the f32 roundoff floor of its residual
        "per_ministep": [[m["iterations"], m["linear_iterations"]]
                         for r in res.reports for m in r["ministeps"]],
    }
    log(f"# {name} slice: " + json.dumps(out))
    return sim, res, schedule[-1], out


def phase_f64_verify(sim, res, forces, name):
    """The final accepted ministep re-assembled in float64 on the card,
    over every row (lattice and wellbore cells)."""
    from jutul.jl_tpu_torch.models.setup import merge_state

    to64 = lambda d: {k: v.double() for k, v in d.items()}  # noqa: E731
    pr = to64(sim.parameters)
    r, _, full = sim._stencil.assemble(
        merge_state(to64(res.final_state_device), pr),
        merge_state(to64(res.final_ministep_start_state), pr),
        res.final_ministep_dt, forces)
    crit = sim.compiled.convergence(r, full, res.final_ministep_dt)
    c = crit["mass_conservation"]
    out = {"rows": r.shape[0], "f64_max_abs_residual": float(r.abs().max()),
           "f64_CNV": float(c["CNV"].max()), "f64_MB": float(c["MB"].max())}
    log(f"# {name} f64 verify: " + json.dumps(out))
    if not (out["f64_CNV"] <= 10 * CNV_TOL and out["f64_MB"] <= 10 * MB_TOL):
        raise RuntimeError(f"{name} f64 verify: residual out of bound: {out}")
    return out


def phase_cross_check(build, dims, smoother, name):
    """The slice at ``dims`` in float64, 2 report steps, on the card and
    on the CPU: identical counts, states within 1e-9."""
    from jutul.jl_tpu_torch import Simulator

    model, state0, params, forces = build(*dims)
    runs = {}
    for dev in ("cuda", "cpu"):
        sim = Simulator(model, state0, params, device=dev,
                        dtype=torch.float64)
        res = sim.simulate([DT] * 2, forces=rate_schedule(forces, 2),
                           **sim_config(64, smoother))
        minis = [m for r in res.reports for m in r["ministeps"]]
        runs[dev] = (res, [(m["iterations"], m["linear_iterations"],
                            m["success"]) for m in minis])
    if runs["cuda"][1] != runs["cpu"][1]:
        raise RuntimeError(f"{name} cross-check: counts differ: "
                           f"card {runs['cuda'][1]} CPU {runs['cpu'][1]}")
    dev_p = dev_s = 0.0
    for sg, sc in zip(runs["cuda"][0].states, runs["cpu"][0].states):
        dev_p = max(dev_p, float(np.max(np.abs(sg["Pressure"] / sc["Pressure"] - 1))))
        dev_s = max(dev_s, float(np.max(np.abs(sg["Saturations"] - sc["Saturations"]))))
    out = {"ministeps": len(runs["cpu"][1]),
           "newtons": sum(m[0] for m in runs["cpu"][1]),
           "linear_iterations": sum(m[1] for m in runs["cpu"][1]),
           "max_rel_dev_pressure": dev_p, "max_abs_dev_saturations": dev_s}
    log(f"# {name} cross-check card vs CPU ({'x'.join(map(str, dims))}, "
        f"f64, {smoother}): " + json.dumps(out))
    if not (dev_p <= 1e-9 and dev_s <= 1e-9):
        raise RuntimeError(f"{name} cross-check: states differ: {out}")
    return out


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    case = build_flagship(*GRID)
    case_w = build_well_flagship(*GRID)
    log(f"# flagship cases built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    records = {name: KernelRecord() for name in KERNEL_INFO}
    phase_kernels(case, records)
    phase_kernels_cheby(case_w, records)
    phase_warm_up()
    slices = {}
    for name, c, smoother in (("srcwells", case, "jacobi"),
                              ("wells", case_w, "chebyshev")):
        sim, res, last_forces, slices[name] = phase_slice(c, name, smoother)
        phase_f64_verify(sim, res, last_forces, name)
        del sim, res
        torch.cuda.empty_cache()
    phase_cross_check(build_flagship, SMALL, "jacobi", "srcwells")
    phase_cross_check(build_well_flagship, WELL_SMALL, "chebyshev", "wells")
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": slices["wells"]["launches"][name],
            "launches_srcwells": slices["srcwells"]["launches"][name],
            "max_abs_err": rec.max_abs["float32"],
            "max_rel_err_f32": rec.max_rel["float32"],
            "max_abs_err_f64": rec.max_abs["float64"],
            "max_rel_err_f64": rec.max_rel["float64"],
            "ms": rec.ms, "plain_ms": rec.plain_ms,
            "graph_ms": rec.graph_ms})
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
