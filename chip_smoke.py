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
   per axis and as the three-axis lattice launch, which must equal the
   three per-axis launches bit for bit and is timed beside them in turns;
   K4 Chebyshev step — every mode and the 2- and 12-step level hooks — on
   every GMG level of the well-model flagship's pressure hierarchy; K8/K9
   whole-level Jacobi/Chebyshev phases (one launch each) on the
   levels they hold — the mid level in the grid form, the coarse one in
   the cluster form — every hook at 2 and 12 sweeps equal to the K2/K4
   chain bit for bit (float32, float64, bfloat16 coefficients) and timed
   per level and hook beside the chain; K10 whole Jacobi phases on
   the fine and mid levels (the launches of ``phase_chunks``, every hook at
   1-3 sweeps and sweep_n at 2 and 12) equal to the K2 chain bit for bit
   (float32, float64, bfloat16 coefficients) and timed per level and hook
   beside the chain and K8's grid form — and checked again, untimed, on
   B8's route (``gmg.slab_double_buffer = True``), which must route every
   level and hook as the default does (the reference runs B2, or B8, on
   the fine level and B3 on the mid; the port runs both on K10); K11 whole
   Chebyshev phases on the same levels (presmooth+residual and postsmooth
   at 1-3 steps: one launch up to the level's depth, the K4 chain beyond)
   equal to the K4 chain and K2's residual bit for bit (float32, float64,
   bfloat16 coefficients) and timed per level and hook beside the chain
   and K9's grid form; K6/K7 fused
   BiCGStab body
   at the Schur system's 2,097,152 values, also against a second call,
   bitwise; K1 on the adjoint's
   transposed operator with the dot identity); beside each, its bound
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s, the larger) and, for
   K1, one cuSPARSE SpMV (torch.sparse.mm) of the same matrix in CSR;
   K1 also against ``StencilCompiledModel.jacobian(...).matvec``, the
   generic Jacobian's plain product;
4. warm-up: the three slices at 16x16x8 on the card (first use of each op);
   source-term slice: the bench flagship with source-term wells at
   256x64x64 = 1,048,576 cells in float32 through
   ``Simulator(use_stencil=True, device="cuda").simulate`` with the bench's
   solver settings (Jacobi GMG), 3 report steps of 6 h; K1, K10 (the fine
   and mid levels' Jacobi phases), the lattice K3 and K8 (the coarse
   solve) must launch in this run and the
   final state be finite; on every stencil slice the GMG level kernels'
   launches must be those the routing gives (two V-cycles per linear
   iteration); after the stencil slices, K10's end-to-end share: this
   slice four times in turns, as routed and with the fine and mid levels
   on the K2 chain (``phase_k10_share``: equal counts and final state,
   s/Newton of each route);
5. its f64 verify: the final accepted ministep's residual re-assembled in
   float64 on the card; CNV and MB within 10x their tolerances;
6. wells slice: the bench flagship with its 5 well models (1,048,576
   lattice + 5 wellbore cells, bordered stencil + Schur-eliminated wells)
   with the Chebyshev GMG smoother, otherwise as phase 4; K1, K3 (lattice
   and, for the perforations, per axis), K11 (the fine and mid levels'
   Chebyshev phases) and K9 (the coarse solve) must launch, K2 and K4
   never;
7. its f64 verify over all lattice and wellbore rows, as phase 5;
8. wells-jacobi-fused slice: the same well flagship with the bench's
   default Jacobi smoother and both opt-ins of bench.py's BENCH_FUSED_BODY=1
   BENCH_GMG_DB=1 (``StencilKrylovSolver(use_fused_body=True)``,
   ``gmg.slab_double_buffer = True``, which routes as the default: K10
   on the fine and mid levels, K8 the coarse solve); K1, K3, K6, K7, K8 and
   K10 must launch, K2 and K4 never, K6 and K7 once per linear iteration;
   its f64 verify;
8b. the schedule path, as bench.py's run_product runs it
   (``sim.lower_schedule(...)`` then ``post(*run(*args))``:
   check-before-solve Newton, Eisenstat-Walker forcing, ``pick_next`` dt
   selection), on the well flagship at full width, 3 report steps:
   ``wells-product`` (Jacobi GMG: K10 phases on the fine and mid levels,
   K8 the coarse solve; plain BiCGStab chain — the bench's defaults) and
   ``wells-product-bf16`` (the same with ``GMG(coef_dtype="bf16")``: the
   bfloat16 entries of K10, K8 and K1's stage-2 matvec must launch, no
   float32 level kernel), each with its f64
   verify; ``wells-jacobi-eager`` (the eager loop at a fixed Krylov rtol on
   the same kernels) beside them; two 2-step runs of the schedule path that
   put the bfloat16 entries of K11 and K9 (Chebyshev smoother, no K2 or
   K4) and K10 under the B8 flag (Jacobi phases) on a full-width path;
   then
   ``refine_solution`` on
   ``wells-product``'s last accepted ministep with the bench's settings
   (float64 polish, tol 1e-8), all on the card: the final max|r| must be
   finite and below the start's;
8c. the adjoint, as bench.py's run_adjoint runs it: ``wells-adjoint`` (the
   well flagship at full width, 2 report steps of 1.5 h through the
   schedule path, then ``solve_adjoint_sensitivities_jit`` of
   G = dt sum(S_w^2) / nc, cold and warm: the λ-solves run K1, K10 and K8
   on the transposed bordered matrix, each step's Jacobian one three-axis
   and one per-axis K3 launch, the differentiable residual none);
   ``adjoint-dot`` (bench.py's dot test in float64 at 64x32x32: <g, δ> within 1e-3 of the
   central difference); ``history-match`` (2 unit-box L-BFGS iterations of
   ``setup_parameter_optimization`` at 64x32x32 must lower the misfit);
8d. the generic engine's adjoint: ``generic-adjoint`` (bench.py run_adjoint
   under BENCH_ADJ_STENCIL=0: wells-adjoint's states, the sweep on
   ``AdjointStorage(linear_solver=ILU(0)-BiCGStab)`` at rtol 1e-6 in
   float32, cold and twice warm: a finite gradient, no kernel launch, the
   warm sweeps equal bit for bit); ``generic-adjoint-dot`` (adjoint-dot's
   test with the generic sweep in float64, ≤ 1e-3);
   ``dict-history-match`` (2 ``DictParameters.optimize`` iterations at
   32x16x16 with the
   default engine and solvers: the misfit must fall); ``generic-setup``
   (``solve_adjoint_generic`` against a directional central difference,
   1e-4) and ``force-gradient`` (``solve_adjoint_forces`` on the 8x8x6 well
   model, 1e-5), both in float64;
9. A/B at 64x32x32 on the card, float32, 2 report steps: both opt-ins,
   the B8 flag alone, neither, and neither from a 2-ulp perturbed
   initial pressure.
   The flag alone must reproduce "neither" bit for bit; the fused body
   (another summation order) must succeed and pass the f64 verify, and
   its counts are reported beside the perturbed run's (phase_ab says why
   counts cannot be held equal there);
9b. eager-options: the well flagship at 64x32x32, 2 report steps, stencil
   engine: per-step
   files and a restart from them (the final state bit for bit), then a run
   with ``ConvergenceMonitorCuttingCriterion``, a
   ``VariableChangeTimestepSelector``, hooks and ``extra_timing``;
10. cross-checks: each slice on a small grid in float64 on the card
   (kernels) against the CPU (plain versions): identical ministep, Newton
   and linear-iteration counts, states within 1e-9 (the Jacobi-phase one
   without the float32-only fused body); the schedule path with forcing at
   8x8x6 likewise; the adjoint's gradients at 8x8x6 in float64 on the card
   against the CPU's on the same states, within 1e-9;
   the generic adjoint's there (λ at rtol 1e-14) against the CPU's and
   against the stencil adjoint's, within 1e-9; the wells cross-check's
   card launches (its levels are under SLAB_MIN_CELLS: the K4 and K2
   chains) and ``wells-small-bf16-cheby`` (the bf16 Chebyshev schedule path
   at 10x10x6 in float32, where the chains' bf16 entries run) are where
   K2 and K4 still launch;
11. generic slice: the generic block-ELL engine,
   ``Simulator(use_stencil=False)``, on srcwells' case (1,048,576 cells,
   float32, 3 report steps, srcwells' Newton settings) with BASELINE.json's
   CPR(AMG + ILU(0))-GMRES(20) at rtol 1e-3 (``generic_config``); its host
   set-up (ELL tables, AMG hierarchy) timed apart; no kernel may launch;
   one assemble, one CPR update and one GMRES iteration timed by CUDA
   events; its f64 verify as phase 5;
12. generic-fused: the slice's first Newton system solved by
   BiCGStab with the fused body (K6/K7 once per iteration, no stencil
   kernel)
   and by the plain chain; both converge, true residuals (float64) within
   10 rtol;
13. generic-engine-check: at full size in float64, one state through both
   engines — the generic residual within 1e-10 of the stencil engine's
   (K3), the generic J v within 1e-10 of the stencil J v (K1) — and the
   generic assemble, CPR update and CPR apply twice: equal bits;
14. the generic slice at 8x8x6 in float64 on the card against the CPU,
   eager and schedule path (EW forcing): identical counts, states within
   1e-9;
15. wells-multimodel: the well flagship with its 5 wells as one-cell
   MultiModel submodels coupled by ``DarcyTransferCrossTerm`` perforations
   (1,048,576 + 5 cells, float32), through the schedule path as
   wells-product runs it (3 report steps, rate ramp, EW forcing), with
   srcwells' Newton settings and BASELINE.json's CPR-GMRES on the
   reservoir behind a Schur elimination of the wells; host set-up timed
   apart, no kernel launch, every step successful, one host read per
   Newton assembly; its f64 verify (CNV over every submodel, MB of the
   coupled system);
16. multimodel-fused: its first Newton system, Schur-reduced, solved by
   BiCGStab on K6/K7 (once per iteration; no stencil kernel), true residual
   within 10 rtol;
17. multimodel-engine-check: wells-multimodel's last accepted ministep in
   float64 at full size, the MultiModel's residual and J v against the
   generic engine's on the well-graph model, within 1e-12;
18. multimodel-cross-check: the well MultiModel at 8x8x6 in float64 on
   the card against the CPU, eager and schedule path: identical counts,
   states within 1e-12, two card runs bitwise equal; its dense-λ adjoint
   card against CPU within 1e-10.
19. weno-transport: BASELINE.json configuration 2 — WENO
   convection-diffusion (``TransportSystem("weno")``, a solid-body
   rotation) on a 1024 x 1024 quad ``UnstructuredMesh`` (1,048,576 cells,
   2,095,104 faces, K = 10), float32, 2 report steps of 4h/pi through
   ``Simulator(use_stencil=False)`` with ILU(0)-GMRES(20); host set-up
   timed apart; no kernel may launch; its f64 verify (Max |r| within 10x
   the 1e-6 tolerance), mass drift and C within [-0.15, 1.15];
20. weno-transport-fused: its first Newton system by BiCGStab on K6/K7
   (once per iteration) and by the plain chain, true residuals within 10
   rtol;
21. weno-engine-check: float64 at full size, ``HelperSimulator``'s
   residual equal to ``CompiledModel.residual`` bit for bit, assemble
   repeated bitwise, BlockELL J v against ``torch.func.jvp`` (1e-12 at
   the first system, JV_LAST_BAR at the last ministep);
22. nfvm-pressure: NTPFA pressure diffusion with a rotated full tensor on
   the same mesh, float32, 2 steps, AMG-GMRES(20), f64 verified;
23. stencil-conditioning (256 x 256): WENO/NFVM weights and ILU(0)-GMRES
   on perturbed against unperturbed quad meshes; the transport
   cross-check (SPU, WENO, avgMPFA, NTPFA at 24 x 20, f64, card against
   CPU, bitwise repeats);
24. helpers-on-card (f64): ``CompositeSystem`` heat + WENO against the
   standalone runs, a ``UnaryTabulatedVariable`` relperm against the
   analytic one, ``data_domain_parameter_gradient`` against central
   differences; each card against CPU within 1e-9.
25. extruded-layers: an SPE10-style layered reservoir (``layered_reservoir``:
   a moved 256 x 256 quad map of a 1 km square extruded into 16 seeded
   layers, 1,048,576 cells; per-layer log-normal permeability through the
   ``"layers"`` cell tags; 4 vertical injectors and a producer deviated in
   three segments, their cells by ``find_enclosing_cells``) through
   ``Simulator(use_stencil=False)`` with CPR-GMRES, float32, 2 report
   steps; host set-up split by ``utils/timing`` scopes; no kernel may
   launch; its f64 verify; ``export_mesh_vtu`` of the final state, timed;
26. coarse-upscaled: its native Metis partition into 16,384 blocks with
   each well's cells forced into one block, ``CoarseMesh`` +
   ``coarsen_data_domain``, the same run; pore volume within 1e-12;
27. cut-fault: the layered reservoir cut by one dipping ``PlaneCut`` at full
   width (if the cut builds within 60 s), slivers merged; volume within
   1e-12; the same run;
28. meshes-cross-check: the layered case at 8 x 8 x 4 in float64, card
   twice against the CPU: equal counts, states within 1e-12, bitwise
   repeats.
29. dd-cross-check (float64): the JAX package's dryrun_multichip case (a
   6x5x4 ``UnstructuredMesh``, gravity, 2 well models, forced well groups
   over 8 shards) through ``GeneralDistributedSimulator`` over
   ``ShardGroup.threads(8)`` on the card (distributed CPR, Chebyshev
   smoothing, ppermute halos), then ``solve_adjoint_sensitivities_general``;
   and tests/test_sharded.py's case on 4 slabs (``DistributedSimulator``,
   distributed CPR) with the slab adjoint: states and gradients within
   1e-6 of the single-device ``Simulator`` and
   ``solve_adjoint_sensitivities``; the dryrun run on the CPU within 1e-12
   of the card's; a world-size-1 NCCL ``ShardGroup.process_group`` run
   equal to ``threads(1)`` bit for bit; and the dryrun's MultiModel form
   (``coupled_dd_case``: 2 replicated well models, a leaky fault inside the
   reservoir, the wells Schur-eliminated) through
   ``GeneralDistributedMultiModel`` and its adjoint on 8 threads, held to
   ``Simulator(mm)`` and ``solve_adjoint_sensitivities`` likewise, the
   replicated wells equal bit for bit on every shard after every
   ministep;
30. dd-slab: srcwells' case (1,048,576 cells, float32) through the slab
   engine over ``ShardGroup.threads(8)`` (eight z-slabs of 8 planes),
   distributed CPR (the global pressure stencil all-gathered and V-cycled
   by GMG on every shard: K10 and K8 must launch), the eager loop with dt
   cuts
   on srcwells' accepted ministep dts and forces of its first report
   step; its f64 verify on the gathered state, and its final state
   against srcwells' at the same time;
31. dd-general: extruded-layers' case (1,048,576 + 5 cells) through
   ``GeneralDistributedSimulator`` over ``ShardGroup.threads(8)`` on the
   native partition with the wells' groups forced, all_to_all halos,
   distributed CPR with Chebyshev smoothing, 2 report steps; no kernel may
   launch; its f64 verify; then the general adjoint of the pressure
   objective over the accepted ministeps in float64 against the
   single-device generic adjoint of the same states: every λ-solve of
   both converged, gradients within 1e-3.
32. dd-multimodel (right after the MultiModel phases): wells-multimodel's
   case (1,048,576 reservoir cells over 8 native blocks, the 5 one-cell
   wells replicated, ``reduction="schur_apply"``) through
   ``GeneralDistributedMultiModel`` on ``ShardGroup.threads(8)``,
   block-Jacobi BiCGStab with Eisenstat-Walker forcing, float32, on the
   first DD_MM_MINISTEPS accepted ministeps of wells-multimodel's first
   report step; no kernel may launch; the wells bitwise equal across
   shards after every ministep; its f64 verify; its state against
   wells-multimodel's engine at the same time; then its float64 adjoint
   over DD_MM_ADJOINT_STEPS ministeps against the single-device generic
   adjoint of the well-graph form of the same states (gradients within
   1e-3, every λ-solve converged).

Phases 1-8 run alone. Then three processes on the same card
(``side_phases``) run phases 15-18 and 32 (``mm``), 29-31 (``dd``) and
19-28 (``tm``) while this one runs the rest; all are bound by the host,
and the eight shard threads of 29-32 take turns in one interpreter. The
side processes' logs follow this one's; a failure of any fails the
script.

Launch counts are set to 0 just before each slice and read just after it.
Output: progress lines, then one JSON line with every kernel's errors,
times, bound and launches (``launches``: its main slice, ``main_slice``;
``launches_by_slice``: every slice), then the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
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
# the same for the schedule path with Eisenstat-Walker forcing, whose looser
# solves amplify roundoff further: at 10x10x6 the JAX package's Schur forms
# take 25, 24 or 26 linear iterations in the eighth ministep and the card
# gives 26 against the CPU's 25; at 8x8x6 (and 12x12x6) all agree
WELL_SMALL_EW = (8, 8, 6)
DT = 6 * 3600.0
CNV_TOL, MB_TOL = 1e-3, 1e-6
# kernel vs plain, max |kernel - plain| / max |plain| per output: float32
# carries ~1e-7 per rounding over up to a few hundred roundings (12 Jacobi
# sweeps; the flux chain's exp/pow/cancellation); float64 the same at 2e-16
REL_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# the card's published peaks (H100 SXM): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCRIPT_LIMIT_S = 1200.0  # the whole script's time limit, the build included
F32_FLOPS = 67e12
KERNEL_INFO = {
    "stencil_matvec": ("jutul/jl_tpu_torch/csrc/stencil_kernels.cu",
                       "jutul/jl_tpu/ops/pallas/stencil_kernels.py:83"),
    "scalar_jacobi": ("jutul/jl_tpu_torch/csrc/stencil_kernels.cu",
                      "jutul/jl_tpu/ops/pallas/stencil_kernels.py:252 (B4 "
                      "_kernel_fused)"),
    "darcy_flux_jacobian": ("jutul/jl_tpu_torch/csrc/assembly_kernels.cu",
                            "jutul/jl_tpu/ops/pallas/assembly_kernels.py:57"),
    "darcy_flux_jacobian_lattice": (
        "jutul/jl_tpu_torch/csrc/assembly_kernels.cu",
        "jutul/jl_tpu/ops/pallas/assembly_kernels.py:57 (B5 _kernel_axis, "
        "called per axis by axis_flux_jacobian :105): the three axes in one "
        "launch"),
    "scalar_chebyshev": (
        "jutul/jl_tpu_torch/csrc/stencil_kernels.cu",
        "jutul/jl_tpu/ops/pallas/stencil_kernels.py:716 (one step of B7 "
        "_kernel_slab_sweeps_cheby's and B6 :431's recurrence: the "
        "per-step chain K9 and K11 are held to, which runs the Chebyshev "
        "phases they do not take; B7's phase is scalar_chebyshev_slab)"),
    "fused_alpha_s": ("jutul/jl_tpu_torch/csrc/krylov_kernels.cu",
                      "jutul/jl_tpu/ops/pallas/krylov_kernels.py:98 (B10 "
                      "_kernel_alpha_s)"),
    "fused_omega_update": ("jutul/jl_tpu_torch/csrc/krylov_kernels.cu",
                           "jutul/jl_tpu/ops/pallas/krylov_kernels.py:130 "
                           "(B11 _kernel_omega_update)"),
    "scalar_sweeps_resident": (
        "jutul/jl_tpu_torch/csrc/level_kernels.cu",
        "jutul/jl_tpu/ops/pallas/stencil_kernels.py:389 (B3 _kernel_sweeps, "
        "called by _scalar_sweeps_call :412)"),
    "scalar_chebyshev_resident": (
        "jutul/jl_tpu_torch/csrc/level_kernels.cu",
        "jutul/jl_tpu/ops/pallas/stencil_kernels.py:431 (B6 "
        "_kernel_sweeps_cheby, called by _scalar_sweeps_cheby_call :468)"),
    "scalar_jacobi_slab": (
        "jutul/jl_tpu_torch/csrc/slab_kernels.cu",
        "jutul/jl_tpu/ops/pallas/stencil_kernels.py:555 (B2 "
        "_kernel_slab_sweeps, called by _scalar_slab_sweeps_call :683) and "
        ":602 (B8 _kernel_slab_sweeps_db, called by "
        "_scalar_slab_sweeps_db_call :648; both compute "
        "_slab_jacobi_compute :582)"),
    "scalar_chebyshev_slab": (
        "jutul/jl_tpu_torch/csrc/slab_kernels.cu",
        "jutul/jl_tpu/ops/pallas/stencil_kernels.py:716 (B7 "
        "_kernel_slab_sweeps_cheby, called by "
        "_scalar_slab_sweeps_cheby_call :773)"),
}
_B9 = ("jutul/jl_tpu_torch/csrc/stencil_kernels.cu",
       "B9 (coef_dtype=bfloat16, jutul/jl_tpu/ops/pallas/stencil_kernels.py"
       ":177-231) via ")
_LEVEL_CU = "jutul/jl_tpu_torch/csrc/level_kernels.cu"
KERNEL_INFO.update({
    "stencil_matvec_bf16c": (_B9[0], _B9[1] + "B1 :83 _kernel"),
    "scalar_jacobi_bf16c": (_B9[0], _B9[1] + "B4 :252"),
    "scalar_chebyshev_bf16c": (_B9[0], _B9[1] + "B7 :716, one step a "
                               "launch (the per-step chain)"),
    "scalar_sweeps_resident_bf16c": (_LEVEL_CU, _B9[1] + "B3 :389"),
    "scalar_chebyshev_resident_bf16c": (_LEVEL_CU, _B9[1] + "B6 :431"),
    "scalar_jacobi_slab_bf16c": ("jutul/jl_tpu_torch/csrc/slab_kernels.cu",
                                 _B9[1] + "B2 :555 and B8 :602"),
    "scalar_chebyshev_slab_bf16c": (
        "jutul/jl_tpu_torch/csrc/slab_kernels.cu", _B9[1] + "B7 :716"),
})
K8, K9 = "scalar_sweeps_resident", "scalar_chebyshev_resident"
K10, K11 = "scalar_jacobi_slab", "scalar_chebyshev_slab"
SLICE_KERNELS = {  # kernels each slice must launch (the per-axis K3:
    # the well perforations; the lattice's three axes go through one launch;
    # K8/K9: the coarse GMG level's solve; K10: the fine and mid levels'
    # Jacobi phases, whatever slab_double_buffer says (the reference: B2 or
    # B8 on the fine level, B3 on the mid); K11: their Chebyshev phases, the
    # residual after a presmooth included (the reference: B7 on the fine
    # level, B6 on the mid))
    "srcwells": ("stencil_matvec", K10, "darcy_flux_jacobian_lattice", K8),
    "wells": ("stencil_matvec", "darcy_flux_jacobian",
              "darcy_flux_jacobian_lattice", K11, K9),
    "wells-jacobi-fused": ("stencil_matvec", "darcy_flux_jacobian",
                           "darcy_flux_jacobian_lattice", K10,
                           "fused_alpha_s", "fused_omega_update", K8),
    "wells-jacobi-eager": ("stencil_matvec", K10, "darcy_flux_jacobian",
                           "darcy_flux_jacobian_lattice", K8),
    "wells-product": ("stencil_matvec", K10, "darcy_flux_jacobian",
                      "darcy_flux_jacobian_lattice", K8),
    "wells-product-bf16": ("stencil_matvec", "stencil_matvec_bf16c",
                           K10 + "_bf16c", "darcy_flux_jacobian",
                           "darcy_flux_jacobian_lattice", K8 + "_bf16c"),
    "wells-product-bf16-cheby": ("stencil_matvec_bf16c", K11 + "_bf16c",
                                 K9 + "_bf16c"),
    "wells-product-bf16-phases": ("stencil_matvec_bf16c", K10 + "_bf16c",
                                  K8 + "_bf16c"),
}
# the bf16 Chebyshev schedule path on the 10x10x6 well model, whose levels
# are all under SLAB_MIN_CELLS: the K4 and K2 chains' bf16 entries run its
# smoothing phases, K9's the coarse solve (``phase_small_chains``)
SLICE_KERNELS["wells-small-bf16-cheby"] = (
    "scalar_jacobi_bf16c", "scalar_chebyshev_bf16c", K9 + "_bf16c")
SLICE_KERNELS["generic"] = ()  # the generic path has no kernel of its own
SLICE_KERNELS["eager-options"] = SLICE_KERNELS["wells-jacobi-eager"]
SLICE_KERNELS["generic-fused"] = ("fused_alpha_s", "fused_omega_update")
# the MultiModel assembles through the generic engine: no kernel of its own
SLICE_KERNELS["wells-multimodel"] = ()
SLICE_KERNELS["multimodel-fused"] = SLICE_KERNELS["generic-fused"]
# the transport slice assembles through the generic engine: no kernel
SLICE_KERNELS["weno-transport"] = ()
SLICE_KERNELS["nfvm-pressure"] = ()
SLICE_KERNELS["weno-transport-fused"] = SLICE_KERNELS["generic-fused"]
_F32_LEVEL = ("scalar_jacobi", "scalar_chebyshev", K8, K9, K10, K11)
# the chains K9, K10 and K11 replace on the flagship's levels
_CHAINS = ("scalar_jacobi", "scalar_chebyshev")
# K1-K4, K8-K11 and every bf16 entry: the stencil engine's kernels
_STENCIL_KERNELS = tuple(k for k in KERNEL_INFO
                         if k not in ("fused_alpha_s", "fused_omega_update"))
SLICE_FORBIDDEN = {  # kernels a slice must never launch
    "generic": tuple(KERNEL_INFO),  # GMRES launches no K6/K7 either
    "generic-fused": _STENCIL_KERNELS,
    "wells-multimodel": tuple(KERNEL_INFO),
    "multimodel-fused": _STENCIL_KERNELS,
    "weno-transport": tuple(KERNEL_INFO),
    "nfvm-pressure": tuple(KERNEL_INFO),
    "weno-transport-fused": _STENCIL_KERNELS,
    "wells": _CHAINS,
    "wells-jacobi-fused": _CHAINS + (K9, K11),
    "wells-product": tuple(k for k in KERNEL_INFO if k.endswith("_bf16c")),
    "wells-product-bf16": _F32_LEVEL,
    "wells-product-bf16-cheby": _F32_LEVEL + tuple(
        k + "_bf16c" for k in _CHAINS),
    "wells-small-bf16-cheby": _F32_LEVEL + (K11 + "_bf16c",),
    "wells-product-bf16-phases": _F32_LEVEL + ("scalar_jacobi_bf16c",),
}
# the slice whose launches a kernel's JSON entry reports as ``launches``
# (K2 and K4 now launch on the full-width slices nowhere: the levels they
# still run, under SLAB_MIN_CELLS outside the coarse solve, are those of the
# wells slice's float64 cross-check on the card and, for their bf16
# entries, of the bf16 Chebyshev schedule path at 10x10x6)
MAIN_SLICE = {"stencil_matvec": "wells-jacobi-fused",
              "scalar_jacobi": "wells-cross-check",
              "darcy_flux_jacobian": "wells-jacobi-fused",
              "darcy_flux_jacobian_lattice": "wells-jacobi-fused",
              "scalar_chebyshev": "wells-cross-check",
              "fused_alpha_s": "wells-jacobi-fused",
              "fused_omega_update": "wells-jacobi-fused",
              K8: "srcwells", K9: "wells",
              "stencil_matvec_bf16c": "wells-product-bf16",
              "scalar_jacobi_bf16c": "wells-small-bf16-cheby",
              "scalar_chebyshev_bf16c": "wells-small-bf16-cheby",
              K11: "wells", K11 + "_bf16c": "wells-product-bf16-cheby",
              K8 + "_bf16c": "wells-product-bf16",
              K9 + "_bf16c": "wells-product-bf16-cheby",
              K10: "srcwells", K10 + "_bf16c": "wells-product-bf16"}
AB_GRID = (64, 32, 32)  # the A/B's 65,536 cells


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


def _well_case(nx, ny, nz, pkg):
    """The numbers of bench.py ``build(nx, ny, nz, gravity=True,
    wells=True, well_models=True)`` through ``pkg``'s classes: the
    reservoir (mesh, fluid, permeability, initial pressure and
    saturation), the 5 ``WellSpec``s (4 rate-controlled injectors
    perforating the bottom layers, 1 BHP-controlled producer perforating
    the top layers, up to 8 completions each), the wellbores' initial
    pressure and saturation, the injection rate, the BHP and the control
    transmissibility."""
    import importlib

    W = importlib.import_module(pkg.__name__ + ".models.wells")
    D = importlib.import_module(pkg.__name__ + ".models.darcy")
    BAR, DARCY = pkg.si_units("bar", "darcy")
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = pkg.CartesianMesh((nx, ny, nz), (100.0 * nx / 128,
                                            100.0 * ny / 128,
                                            10.0 * nz / 64))
    fluid = D.ImmiscibleFluid(viscosities=(1e-3, 2e-3))
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
    ncomp = min(8, nz)
    inj_cols = [(1, 1), (nx - 2, 1), (1, ny - 2), (nx - 2, ny - 2)]
    WI = 2.5e-13  # Peaceman-style, ~ an interior face transmissibility
    specs = [W.WellSpec(f"inj{i}",
                        [cell(ix, iy, nz - 1 - k) for k in range(ncomp)],
                        WI=WI, volume=1.0)
             for i, (ix, iy) in enumerate(inj_cols)]
    specs.append(W.WellSpec(
        "prod", [cell(nx // 2, ny // 2, k) for k in range(ncomp)],
        WI=WI, volume=1.0))
    return dict(
        W=W, D=D, mesh=mesh, fluid=fluid, perm=perm, sw=sw, p0=p0,
        specs=specs,
        # wellbore initial state: completion-top pressure; injectors start
        # water-filled, the producer at the completion saturation
        pw=np.array([p0[s.cells[0]] for s in specs]),
        sww=np.array([1.0] * 4 + [float(sw[specs[-1].cells[0]])]),
        q=0.2 * pore_mass / 21600.0,  # kg/s per injector
        bhp=float(p0[specs[-1].cells[0]]) - 2.0 * BAR,
        # BHP control: a fixed-pressure surface connection whose control
        # transmissibility (10x the completions' WI) dominates the row
        t_ctl=10.0 * WI * ncomp)


def build_well_flagship(nx, ny, nz):
    """The bench flagship with its 5 well models, through the port's API:
    a copy of bench.py ``build(nx, ny, nz, gravity=True, wells=True,
    well_models=True)`` — the same reservoir as ``build_flagship`` plus the
    wells of ``_well_case`` as wellbore cells of a WellGraphMesh. Returns
    (model, state0, parameters, forces); state0 and parameters are host
    numpy dicts."""
    import jutul.jl_tpu_torch as pkg

    c = _well_case(nx, ny, nz, pkg)
    model, wmesh, params = c["W"].setup_well_graph_model(
        c["mesh"], c["fluid"], c["specs"], permeability=c["perm"],
        porosity=0.25, gravity=True)
    sw, sww = c["sw"], c["sww"]
    state0 = pkg.setup_state(
        model, Pressure=np.concatenate([c["p0"], c["pw"]]),
        Saturations=np.stack([np.concatenate([sw, sww]),
                              np.concatenate([1 - sw, 1 - sww])], axis=1))
    inj_cells = [wmesh.well_cells[f"inj{i}"] for i in range(4)]
    forces = {
        # rate control: surface water stream into each injector
        "rate": pkg.PhaseSourceTerm(inj_cells,
                                    np.array([[c["q"], 0.0]] * 4)),
        "bhp": pkg.PressureBoundaryCondition(
            [wmesh.well_cells["prod"]], c["bhp"], c["t_ctl"],
            saturations=[0.5, 0.5]),
    }
    return model, state0, params, forces


WELL_NAMES = ("inj0", "inj1", "inj2", "inj3", "prod")


def build_well_multimodel(nx, ny, nz, pkg=None):
    """The well flagship of ``build_well_flagship`` as a MultiModel: the
    reservoir through ``setup_darcy_model`` on the CartesianMesh and the 5
    wells as one-cell models coupled by skew-symmetric
    ``DarcyTransferCrossTerm`` perforations (``setup_well_multimodel``),
    from the same numbers, with the controls on the well models.
    ``pkg``: the package whose classes to use (default the port; the CPU
    tests pass the JAX package for the reference run). Returns
    (multimodel, state0, parameters, forces), each a dict per submodel of
    host numpy data (forces: of force objects)."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    c = _well_case(nx, ny, nz, pkg)
    D = c["D"]
    res = D.setup_darcy_model(c["mesh"], c["fluid"], permeability=c["perm"],
                              porosity=0.25, gravity=True)
    mm, names = c["W"].setup_well_multimodel(res, c["specs"])
    assert tuple(names) == WELL_NAMES
    sw = c["sw"]
    state0 = {"reservoir": pkg.setup_state(
        res, Pressure=c["p0"], Saturations=np.stack([sw, 1 - sw], axis=1))}
    for i, n in enumerate(names):
        state0[n] = pkg.setup_state(
            mm[n], Pressure=c["pw"][i:i + 1],
            Saturations=np.array([[c["sww"][i], 1 - c["sww"][i]]]))
    forces = {"reservoir": None}
    for i in range(4):
        forces[f"inj{i}"] = {"rate": D.PhaseSourceTerm(
            [0], np.array([[c["q"], 0.0]]))}
    forces["prod"] = {"bhp": D.PressureBoundaryCondition(
        [0], c["bhp"], c["t_ctl"], saturations=[0.5, 0.5])}
    return mm, state0, pkg.setup_parameters(mm), forces


TRANSPORT_GRID = (1024, 1024)  # BASELINE.json configuration 2's mesh


def perturbed_quad_mesh(nx, ny, pkg=None, seed=0, amp=0.2):
    """``UnstructuredMesh.from_cartesian`` of the unit square's nx x ny
    CartesianMesh with every interior node moved by a uniform offset in
    [-amp h, amp h] per axis (h = 1/nx, 1/ny), from
    ``numpy.random.default_rng(seed)``; boundary nodes stay. ``pkg``: the
    package whose classes to use (default the port)."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    m = pkg.UnstructuredMesh.from_cartesian(
        pkg.CartesianMesh((nx, ny), (1.0, 1.0)))
    pts = m.points.copy()
    i, j = np.arange(nx + 1), np.arange(ny + 1)
    inner = ((i[None, :] > 0) & (i[None, :] < nx)
             & (j[:, None] > 0) & (j[:, None] < ny)).reshape(-1)
    rng = np.random.default_rng(seed)
    pts[inner] += rng.uniform(-amp, amp, (int(inner.sum()), 2)) \
        * np.array([1.0 / nx, 1.0 / ny])
    return pkg.UnstructuredMesh(pts, m.face_nodes, m.face_neighbors,
                                m.boundary_face_nodes, m.boundary_face_cells)


def transport_dt(nx):
    """The transport cases' report step, 4h/pi: CFL 2-3.5 along the
    pulse's orbit, 5.7 in the corners."""
    return 4.0 / (nx * np.pi)


def build_transport(nx, ny, scheme="weno", pkg=None, mesh=None):
    """BASELINE.json configuration 2: ``TransportSystem(scheme)`` on
    ``perturbed_quad_mesh(nx, ny)`` (or ``mesh``) with the
    ``rotation_parameters``; C = 1 on [0.2, 0.4]^2, else 0. Returns
    (model, state0, parameters) as host numpy data."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    T = importlib.import_module(pkg.__name__ + ".models.transport")
    mesh = mesh or perturbed_quad_mesh(nx, ny, pkg)
    model = pkg.SimulationModel(pkg.DataDomain(mesh),
                                T.TransportSystem(scheme))
    cc = model.data_domain.geometry.cell_centroids
    C0 = np.where(np.all((cc >= 0.2) & (cc <= 0.4), axis=1), 1.0, 0.0)
    params = {**pkg.setup_parameters(model), **rotation_parameters(model)}
    return model, pkg.setup_state(model, C=C0), params


def rotation_parameters(model):
    """FaceVelocity: a solid-body rotation about (1/2, 1/2) at one
    revolution per unit time, v . n A at the face centroids;
    FaceDiffusion 1e-4 A / |x_R - x_L|."""
    geo = model.data_domain.geometry
    fc, cc = geo.face_centroids, geo.cell_centroids
    vel = 2.0 * np.pi * np.stack([0.5 - fc[:, 1], fc[:, 0] - 0.5], axis=1)
    L, R = geo.neighbors[:, 0], geo.neighbors[:, 1]
    return {"FaceVelocity": np.einsum("fi,fi->f", vel,
                                      geo.normals) * geo.areas,
            "FaceDiffusion": 1e-4 * geo.areas / np.linalg.norm(
                cc[R] - cc[L], axis=1)}


def run_composite(dims, scheme="weno", pkg=None, n_step=3, amp=0.2,
                  solver=None, **sim_kw):
    """``CompositeSystem(heat=SimpleHeatSystem(),
    tracer=TransportSystem(scheme))`` and the two standalone models on one
    mesh, each run ``n_step`` steps through ``Simulator`` (default engine;
    ``solver`` a function of the package giving the linear solver, default
    the package's default; ``sim_kw`` places the run). 1D ``dims``: the
    JAX package's tests/test_composite.py case (12 cells, velocity 0.5,
    dt 1e-3); 2D: ``perturbed_quad_mesh(*dims, amp=amp)`` with the
    ``rotation_parameters`` and steps of 0.05 x 4h/pi. T0 = cos(pi x), C0
    the pulse of ``build_transport`` (in 1D seeded uniform). Returns the
    three results (composite, heat, tracer)."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    T = importlib.import_module(pkg.__name__ + ".models.transport")
    if len(dims) == 1:
        mesh = pkg.CartesianMesh(dims, (1.0,))
        geo = mesh.tpfv_geometry()
        extra = {"FaceVelocity": T.uniform_face_velocity(geo, [0.5])}
        C0 = np.random.default_rng(0).uniform(0, 1, dims[0])
        dt = 1e-3
    else:
        mesh = perturbed_quad_mesh(*dims, pkg, amp=amp)
        geo = mesh.tpfv_geometry()
        extra = None
        cc = geo.cell_centroids
        C0 = np.where(np.all((cc >= 0.2) & (cc <= 0.4), axis=1), 1.0, 0.0)
        dt = 0.05 * transport_dt(dims[0])
    T0 = np.cos(np.pi * geo.cell_centroids[:, 0])
    cfg = {} if solver is None else {"linear_solver": solver(pkg)}
    out = []
    for system, init in (
            (pkg.CompositeSystem(heat=pkg.SimpleHeatSystem(),
                                 tracer=T.TransportSystem(scheme)),
             dict(T=T0, C=C0)),
            (pkg.SimpleHeatSystem(), dict(T=T0)),
            (T.TransportSystem(scheme), dict(C=C0))):
        model = pkg.SimulationModel(pkg.DataDomain(mesh), system)
        params = pkg.setup_parameters(model)
        if "FaceVelocity" in params:
            params.update(extra or rotation_parameters(model))
        sim = pkg.Simulator(model, state0=pkg.setup_state(model, **init),
                            parameters=params, **sim_kw)
        res = sim.simulate([dt] * n_step, info_level=-1, **cfg)
        if not all(r["success"] for r in res.reports):
            raise RuntimeError(f"run_composite: {system!r} failed")
        out.append(res)
    return out


def nfvm_permeability(nc):
    """R(30 deg) diag(10, 1) R(30 deg)^T in every cell, unit-free."""
    th = np.deg2rad(30.0)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return np.tile((R @ np.diag([10.0, 1.0]) @ R.T)[None], (nc, 1, 1))


def build_nfvm(nx, ny, scheme="ntpfa", pkg=None, mesh=None, width=0.05):
    """``NFVMPressureSystem(scheme, compressibility=1.0)`` on
    ``perturbed_quad_mesh(nx, ny)`` (or ``mesh``) with the full-tensor
    ``nfvm_permeability``; p = 1 + exp(-|x - (1/2, 1/2)|^2 / (2 width^2)).
    Returns (model, state0, parameters) as host numpy data."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    T = importlib.import_module(pkg.__name__ + ".models.transport")
    mesh = mesh or perturbed_quad_mesh(nx, ny, pkg)
    nc = mesh.number_of_cells()
    dd = pkg.DataDomain(mesh, permeability=nfvm_permeability(nc))
    model = pkg.SimulationModel(dd, T.NFVMPressureSystem(
        scheme, compressibility=1.0))
    cc = dd.geometry.cell_centroids
    p0 = 1.0 + np.exp(-np.sum((cc - 0.5) ** 2, axis=1) / (2 * width ** 2))
    return model, pkg.setup_state(model, Pressure=p0), \
        pkg.setup_parameters(model)


NFVM_DT = 1e-5  # about 10 cells of diffusion per step at 1024 x 1024


def rate_schedule(forces, n_step):
    """Per-report-step forces with the bench's rate ramp (bench.py:570-579):
    the rates (key ``"rate"`` with well models, ``"wells"`` with
    source-term wells) scale 0.75x -> 1.25x across the report steps; every
    other force (the BHP producer) stays as it is. A MultiModel's forces
    (a dict per submodel) ramp each submodel's rates the same way."""
    if all(f is None or isinstance(f, dict) for f in forces.values()):
        per = {m: (rate_schedule(f, n_step) if f and "rate" in f
                   else [f] * n_step) for m, f in forces.items()}
        return [{m: per[m][i] for m in forces} for i in range(n_step)]
    key = "rate" if "rate" in forces else "wells"
    src = forces[key]
    base = np.asarray(src.values)
    return [{**forces, key: type(src)(
        src.cells, base * (0.75 + 0.5 * i / max(n_step - 1, 1)))}
        for i in range(n_step)]


def sim_config(min_cells, smoother="jacobi", fused=False, coef_dtype=None,
               product=False):
    """The bench product path's solver and Newton settings
    (bench.py:528-601). ``fused``: bench.py's BENCH_FUSED_BODY=1 and
    BENCH_GMG_DB=1 (the fused BiCGStab body K6/K7, and
    ``gmg.slab_double_buffer``, which routes as the default);
    ``coef_dtype``: its BENCH_GMG_COEF_DTYPE; ``product``: the schedule
    path's own options (Eisenstat-Walker forcing, 16 ministep
    records per report step) for ``lower_schedule`` / ``simulate_jit``.

    The slices srcwells, wells, wells-jacobi-fused and wells-jacobi-eager
    run these settings through ``Simulator.simulate`` — the eager loop:
    solve, then check, at the fixed Krylov rtol. The wells-product slices
    run them through the schedule path, as bench.py does."""
    from jutul.jl_tpu_torch import (
        GMG,
        IterationTimestepSelector,
        StencilCPR,
        StencilKrylovSolver,
        TimestepSelector,
    )

    gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=min_cells,
              smoother=smoother, coef_dtype=coef_dtype)
    gmg.slab_double_buffer = fused
    extra = dict(linear_forcing="ew", jit_report_capacity=16) if product \
        else {}
    return dict(
        **extra,
        linear_solver=StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=gmg), rtol=1e-3, max_iterations=25,
            use_fused_body=True if fused else None),
        tolerances={"mass_conservation/CNV": CNV_TOL,
                    "mass_conservation/MB": MB_TOL},
        max_nonlinear_iterations=12, tol_factor_final_iteration=10.0,
        timestep_selectors=[TimestepSelector(initial_fraction=0.25),
                            IterationTimestepSelector(target_iterations=6)],
        output_variables="primary", info_level=-1)


def generic_solver(pkg=None):
    """BASELINE.json's solver for the generic engine: CPR(AMG + ILU(0))
    preconditioned GMRES(20) at rtol 1e-3 and at most 50 iterations.
    ``pkg``: the package whose classes to use (default the port; the CPU
    tests pass the JAX package for the reference run)."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    return pkg.GenericKrylov("gmres", preconditioner=pkg.CPRPreconditioner(),
                             rtol=1e-3, max_iterations=50, restart=20)


def generic_config(pkg=None, solver=None, product=False):
    """The generic slice's settings: srcwells' Newton settings from
    ``sim_config`` with ``generic_solver`` (or ``solver``) in place of the
    stencil solver; ``product``: the schedule path's options."""
    cfg = sim_config(64, product=product)
    cfg["linear_solver"] = solver or generic_solver(pkg)
    if pkg is not None:
        cfg["timestep_selectors"] = [
            pkg.TimestepSelector(initial_fraction=0.25),
            pkg.IterationTimestepSelector(target_iterations=6)]
    return cfg


def multimodel_solver(pkg=None):
    """BASELINE.json's solver behind a Schur elimination of the five
    wells: GMRES(20) at rtol 1e-3 over at most 50 iterations on the
    reservoir, preconditioned per submodel by CPR(AMG + ILU(0))
    (``GroupWisePreconditioner``), with the wellbores eliminated densely
    (``SchurComplementSolver``). ``pkg``: as ``generic_solver``."""
    import importlib

    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    P = importlib.import_module(pkg.__name__ + ".linsolve.precond")
    S = importlib.import_module(pkg.__name__ + ".linsolve.schur")
    return S.SchurComplementSolver(
        inner=pkg.GenericKrylov(
            "gmres", P.GroupWisePreconditioner(pkg.CPRPreconditioner()),
            rtol=1e-3, max_iterations=50, restart=20),
        elim_models=list(WELL_NAMES))


def multimodel_config(pkg=None, product=False):
    """The well MultiModel's settings: srcwells' Newton settings
    (``generic_config``) with ``multimodel_solver``, and the bench's
    tolerances named for every submodel's equation
    (``"reservoir.mass_conservation/CNV"``, ...): the MultiModel's
    equations carry their model's name, and the tolerance lookup (the JAX
    package's ``tolerance_for``) does not map the bench's bare
    ``"mass_conservation/CNV"`` onto them. The reservoir gets the bench's
    CNV and MB; each one-cell well model gets the CNV tolerance for both,
    since for one cell MB (|Σ r| dt / Σ ρ V) is CNV (max |r| dt / ρ V):
    the well-graph model holds its wellbore rows to CNV and lets them
    into a global MB dominated by the reservoir's mass. A wellbore's own
    balance held to the bench's MB cannot be met in float32: one ulp of a
    2e7 Pa pressure across a perforation (WI 2.5e-13) moves a 1 m³
    wellbore's balance by ~3e-6 over a 1.5 h ministep."""
    cfg = generic_config(pkg, multimodel_solver(pkg), product=product)
    cfg["tolerances"] = {
        "reservoir.mass_conservation/CNV": CNV_TOL,
        "reservoir.mass_conservation/MB": MB_TOL,
        **{f"{w}.mass_conservation/{c}": CNV_TOL
           for w in WELL_NAMES for c in ("CNV", "MB")}}
    return cfg


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
    """Worst errors and the flagship-shape times of one kernel, with the
    bytes and operations of the timed call (for its bound) and the time
    of one PyTorch call computing the same function, where there is one."""

    def __init__(self):
        self.max_abs = {}
        self.max_rel = {}
        self.ms = self.plain_ms = self.graph_ms = None
        self.bytes = self.ops = None
        self.library_ms = None
        self.extra = {}

    def set_work(self, tensors, ops):
        """The timed call's bytes (each input read once, each output
        written once: ``tensors``) and float32 operations."""
        self.bytes = int(sum(t.numel() * t.element_size() for t in tensors))
        self.ops = int(ops)

    def bound(self):
        """(bound_ms, bound_by): the larger of bytes over the HBM rate and
        operations over the float32 peak."""
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.ops / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

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


TERMS_K1 = 7  # stencil terms


def _csr(coef, L, C, K):
    """The block-stencil matrix of ``coef`` (7, C*K, n) as a
    (n*C, n*K) CSR tensor on its device, rows i*C + c, columns j*K + k —
    the layout of K1's flattened (n, C) / (n, K) vectors."""
    nz, ny, nx = L
    n = nz * ny * nx
    i = torch.arange(n, device=coef.device)
    x, y, z = i % nx, (i // nx) % ny, i // (nx * ny)
    every = torch.ones_like(i, dtype=torch.bool)
    terms = ((0, every), (1, x + 1 < nx), (-1, x > 0), (nx, y + 1 < ny),
             (-nx, y > 0), (nx * ny, z + 1 < nz), (-nx * ny, z > 0))
    rows, cols, vals = [], [], []
    for t, (off, ok) in enumerate(terms):
        ii = i[ok]
        for c in range(C):
            for k in range(K):
                rows.append(ii * C + c)
                cols.append((ii + off) * K + k)
                vals.append(coef[t, c * K + k][ok])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n * C, n * K))
    return coo.coalesce().to_sparse_csr()


K1_COPIES = 4  # input copies a cold K1 timing rotates over


def k1_entry(key, mv, x, timed=True, library=True):
    """K1 (``mv``, a StencilMatvec) at one of the main path's shapes on
    ``x``: its output must equal K1's original mapping
    (``stencil_matvec_reference``, on the widened coefficients for a
    bfloat16 entry) bit for bit, or this raises. ``timed``: graph ms in
    turns with the reference (reference, K1, K1, reference), "warm" on
    the same inputs at every call (as every other graph time here, so
    what the 50 MB L2 keeps from the previous call is served from there)
    and "cold" rotating over ``K1_COPIES`` copies of the inputs (each call
    finds them evicted, as on the main path); eager and plain ms; the
    bound (coef, x and y bytes once); with ``library``, cuSPARSE's CSR
    SpMV on the same matrix. Returns the row."""
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK

    L, C, K = mv.L, mv.C, mv.K
    wide = mv.coef if mv.coef.dtype == x.dtype else mv.coef.to(x.dtype)
    y = mv(x)
    ref = SK.stencil_matvec_reference(wide, x, L, C, K)
    torch.cuda.synchronize()
    if not torch.equal(y, ref):
        raise RuntimeError(f"K1 {key}: differs from the original mapping")
    log(f"  K1 {key}: bitwise equal to the original mapping")
    if not timed:
        return None
    copies = [(mv.coef, wide, x)] + [
        (mv.coef.clone(), wide.clone(), x.clone())
        for _ in range(K1_COPIES - 1)]
    state = {"i": 0}

    def rotating(reference):
        def run():
            c, w, xx = copies[state["i"] % K1_COPIES]
            state["i"] += 1
            if reference:
                return SK.stencil_matvec_reference(w, xx, L, C, K)
            return SK.stencil_matvec(c, xx, L, C, K)
        return run

    new = lambda: mv(x)  # noqa: E731
    old = lambda: SK.stencil_matvec_reference(wide, x, L, C, K)  # noqa: E731
    warm = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
    cold = [graph_ms(rotating(True)), graph_ms(rotating(False)),
            graph_ms(rotating(False)), graph_ms(rotating(True))]
    del copies[1:]
    nbytes = sum(t.numel() * t.element_size() for t in (mv.coef, x, y))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"C": C, "K": K, "coef_dtype": str(mv.coef.dtype)[6:],
           "graph_ms": (warm[1] + warm[2]) / 2,
           "reference_graph_ms": (warm[0] + warm[3]) / 2,
           "cold_graph_ms": (cold[1] + cold[2]) / 2,
           "reference_cold_graph_ms": (cold[0] + cold[3]) / 2,
           "graph_ms_turns_reference_k1_k1_reference": warm,
           "cold_graph_ms_turns_reference_k1_k1_reference": cold,
           "eager_ms": cuda_ms(new), "reference_eager_ms": cuda_ms(old),
           "plain_ms": cuda_ms(
               lambda: SK.stencil_matvec_plain(mv.coef, x, L, C, K)),
           "bound_ms": bound, "bound_bytes": nbytes, "library_ms": None}
    row["share_of_bound"] = bound / row["graph_ms"]
    row["cold_share_of_bound"] = bound / row["cold_graph_ms"]
    if library:
        csr = _csr(wide, L, C, K)
        xf = x.reshape(-1, 1)
        row["library_vs_kernel_rel_err"] = rel_err(
            torch.sparse.mm(csr, xf).reshape(-1, C), y)
        row["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, xf))
        row["library_call"] = ("torch.sparse.mm (cuSPARSE SpMV), CSR, "
                               f"{csr.values().numel()} nonzeros")
        del csr
    log(f"  K1 {key}: graph ms {row['graph_ms']:.4f} (original mapping "
        f"{row['reference_graph_ms']:.4f}), cold {row['cold_graph_ms']:.4f} "
        f"({row['reference_cold_graph_ms']:.4f}), eager {row['eager_ms']:.4f}"
        f", plain {row['plain_ms']:.4f}, bound {bound:.4f} "
        f"({row['share_of_bound']:.0%} warm, "
        f"{row['cold_share_of_bound']:.0%} cold), cuSPARSE "
        f"{row['library_ms']}")
    return row


def kernel_checks(case, records):
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
        rec_l = records["darcy_flux_jacobian_lattice"]
        calls, fps = [], []
        for a in range(3):
            fs = sc._axis_face_state(faces, a)
            fps.append(tuple(fs[nm] for nm in sc.form.face_params))
            args = (sc.form, U, *fps[a], L, a)
            rec.compare(dtype, f"K3 axis {a}", AK.darcy_flux_jacobian(*args),
                        AK.darcy_flux_jacobian_plain(*args))
            calls.append(args)
        lat = AK.darcy_flux_jacobian_lattice(sc.form, U, fps, L)
        lat_plain = AK.darcy_flux_jacobian_lattice_plain(sc.form, U, fps, L)
        for a in range(3):
            rec_l.compare(dtype, f"K3 lattice axis {a}", lat[a], lat_plain[a])
            if not torch.equal(lat[a], AK.darcy_flux_jacobian(*calls[a])):
                raise RuntimeError(f"K3 lattice axis {a} [{dtype}]: differs "
                                   "from the per-axis kernel")
        log(f"  K3 lattice = three per-axis launches, bitwise [{dtype}]")
        if dtype == torch.float32:
            faces_n = sum(o.shape[-1] for o in lat)
            # U once, each axis's face parameters, the 3 outputs; ~150
            # flops per face (the kernel source's count)
            work = [U] + [t for fp in fps for t in fp] + lat
            rec.set_work(work, 150 * faces_n)
            rec_l.set_work(work, 150 * faces_n)
            per_axis = lambda: [AK.darcy_flux_jacobian(*c) for c in calls]  # noqa: E731
            lattice = lambda: AK.darcy_flux_jacobian_lattice(  # noqa: E731
                sc.form, U, fps, L)
            # in turns within this call: per-axis, lattice, lattice, per-axis
            turns = [graph_ms(per_axis), graph_ms(lattice), graph_ms(lattice),
                     graph_ms(per_axis)]
            rec.graph_ms = (turns[0] + turns[3]) / 2
            rec_l.graph_ms = (turns[1] + turns[2]) / 2
            rec_l.extra["graph_ms_turns_per_axis_lattice_lattice_per_axis"] = \
                turns
            rec_l.extra["per_axis_3_calls_graph_ms"] = rec.graph_ms
            rec.extra["timed"] = "the lattice's three axes, one call each"
            rec.ms = cuda_ms(per_axis)
            rec_l.ms = cuda_ms(lattice)
            rec.plain_ms = cuda_ms(
                lambda: [AK.darcy_flux_jacobian_plain(*c) for c in calls],
                reps=5)
            rec_l.plain_ms = cuda_ms(
                lambda: AK.darcy_flux_jacobian_lattice_plain(sc.form, U, fps,
                                                             L), reps=5)
            log(f"  K3 graph ms: per-axis x3 {rec.graph_ms:.4f}, lattice "
                f"{rec_l.graph_ms:.4f} (turns {turns})")

        _, A, _ = sc.assemble(merge_state(st, pr), merge_state(st, pr), DT)
        rec = records["stencil_matvec"]
        # K1 against the generic Jacobian's plain matvec (ROADMAP A10's
        # oracle: the same matrix assembled by jvps, no kernel)
        A_gen = sc.jacobian(full, full, DT)
        x = torch.randn((A.n, 2), generator=gen, device="cuda", dtype=dtype)
        rec.compare(dtype, "K1 vs StencilCompiledModel.jacobian().matvec",
                    SK.StencilMatvec(A)(x), A_gen.matvec(x))
        del A_gen
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
            # every entry the main path launches: timed beside the
            # original mapping; f64 K = 1 (refine's stage 2) only checked
            timed = dtype == torch.float32 or K == 2
            key = f"{str(dtype)[6:]} {tag}"
            row = k1_entry(key, mv, x, timed=timed)
            if timed:
                rec.extra.setdefault("entries", {})[key] = row
            if dtype == torch.float32 and K == 2:
                rec.set_work([mv.coef, x, mv(x)],
                             2 * TERMS_K1 * C * K * A.n)
                rec.library_ms = row["library_ms"]
                rec.extra["library_vs_kernel_rel_err"] = \
                    row["library_vs_kernel_rel_err"]
                rec.extra["library_call"] = row["library_call"]
                rec.ms, rec.graph_ms = row["eager_ms"], row["graph_ms"]
                rec.plain_ms = cuda_ms(
                    lambda: SK.stencil_matvec_plain(mv.coef, x, L, C, K))

        rec = records["scalar_jacobi"]
        cpr = StencilCPR(gmg=GMG(n_smooth=2, n_coarse_sweeps=12,
                                 min_cells=16384))
        pst = cpr.update(A)
        om = cpr.gmg.omega
        for op in pst.ops:  # every level through the K2 chain
            lv = SK.ScalarLevel(op, resident=False, slab=False)
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
            if dtype == torch.float32 and op is pst.ops[0]:
                rec.set_work([lv.coef, b, u, b], 18 * n)
                rec.ms = cuda_ms(lambda: lv.smooth(u, b, om))
                rec.graph_ms = graph_ms(lambda: lv.smooth(u, b, om))
                rec.plain_ms = cuda_ms(lambda: SK.scalar_jacobi_plain(
                    lv.coef, b, u, om, SK.MODE_SMOOTH, lv.L))
        del A, pst
        torch.cuda.empty_cache()


def kernel_checks_cheby(case, records):
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
        for op, steps in zip(pst.ops, pst.cheb):  # the K4 chain
            lv = SK.ScalarLevel(op, resident=False, slab=False)
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
            if dtype == torch.float32 and op is pst.ops[0]:
                # coef, b, u, d, the step table in; u', d' out
                rec.set_work([lv.coef, b, u, d, steps[1], u, d], 21 * n)
                rec.ms = cuda_ms(lambda: step(SK.scalar_chebyshev, u, d, 1,
                                              SK.CHEB_STEP))
                rec.graph_ms = graph_ms(lambda: step(
                    SK.scalar_chebyshev, u, d, 1, SK.CHEB_STEP))
                rec.plain_ms = cuda_ms(lambda: step(
                    SK.scalar_chebyshev_plain, u, d, 1, SK.CHEB_STEP))
        del B, pst
        torch.cuda.empty_cache()


def _in_turns(fn_a, fn_b):
    """Graph ms of ``fn_a`` and ``fn_b`` measured a, b, b, a in this call:
    (mean a, mean b, the four)."""
    t = [graph_ms(fn_a), graph_ms(fn_b), graph_ms(fn_b), graph_ms(fn_a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def kernel_checks_bf16(case, records):
    """The bfloat16-coefficient entries of K1 (K=1: CPR's stage-2 matvec),
    K2 and K4 on every level of the well flagship's Jacobi and
    Chebyshev hierarchies built with ``GMG(coef_dtype="bf16")``, float32
    vectors. Each against the float32 entry on the same coefficients
    rounded to bfloat16 and widened — bit for bit, or it raises: the
    coefficient is widened at its load and nothing else changes — and
    against its plain version; timed eagerly and as graph replays in turns
    with the float32 entry; the bound counts 2-byte coefficients. K1's
    entry also equals its original mapping on the widened coefficients,
    bit for bit, and is timed beside it (``k1_entry``)."""
    from jutul.jl_tpu_torch import compile_model, from_numpy
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
    from jutul.jl_tpu_torch.ops.stencil import GMG, StencilCPR
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    model, state0, params, forces = case
    eng = BorderedStencilModel(compile_model(model), "cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    full = merge_state(from_numpy(state0, "cuda", f32),
                       from_numpy(params, "cuda", f32))
    _, B, _ = eng.assemble(full, full, DT, forces)
    A = B.A
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda",  # noqa: E731
                                 dtype=f32)

    def same(what, got, want):
        for g, w in zip(got, want):
            if (g is None) != (w is None) or \
                    (g is not None and not torch.equal(g, w)):
                raise RuntimeError(
                    f"{what}: the bfloat16 entry differs from the float32 "
                    "entry on the rounded coefficients")

    def wide(lv, op):
        """``lv``'s level through the float32 entries on its coefficients
        widened."""
        lv32 = SK.ScalarLevel(op, resident=lv.resident, slab=lv.slab)
        lv32.coef = lv.coef.to(f32)
        return lv32

    def timings(rec, fn16, fn32, plain, what):
        rec.graph_ms, g32, turns = _in_turns(fn16, fn32)
        rec.ms, rec.plain_ms = cuda_ms(fn16), cuda_ms(plain)
        rec.extra.update({
            "timed": what, "f32_entry_graph_ms": g32,
            "f32_entry_ms": cuda_ms(fn32),
            "graph_ms_turns_bf16_f32_f32_bf16": turns})
        log(f"  {what}: graph ms bf16 {rec.graph_ms:.4f} / f32 entry "
            f"{g32:.4f} (turns {turns})")

    # K1, K=1, C=2: the pressure-column matvec of CPR's stage 2
    gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384,
              coef_dtype="bf16")
    pst = StencilCPR(gmg=gmg).update(A)
    log(f"# bf16 coefficients vs the f32 entries (bitwise) and vs plain, "
        f"levels {[lv.L for lv in pst.mvs]}")
    rec = records["stencil_matvec_bf16c"]
    mv = pst.mv_Ap
    if mv.coef.dtype != bf16 or pst.mv_A.coef.dtype != f32:
        raise RuntimeError("CPR: mv_Ap must be bfloat16, mv_A float32")
    c32 = mv.coef.to(f32)
    x = rnd(A.n, 1)
    y = mv(x)
    same("K1 K=1", [y], [SK.stencil_matvec(c32, x, mv.L, 2, 1)])
    rec.compare(f32, "K1 bf16 mv_Ap C=2,K=1", y,
                SK.stencil_matvec_plain(mv.coef, x, mv.L, 2, 1))
    # no one call multiplies bfloat16 coefficients into float32 vectors
    rec.extra["entries"] = {"bfloat16 mv_Ap C=2,K=1": k1_entry(
        "bfloat16 mv_Ap C=2,K=1", mv, x, library=False)}
    rec.set_work([mv.coef, x, y], 2 * TERMS_K1 * 2 * A.n)
    timings(rec, lambda: mv(x),
            lambda: SK.stencil_matvec(c32, x, mv.L, 2, 1),
            lambda: SK.stencil_matvec_plain(mv.coef, x, mv.L, 2, 1),
            "K1 bf16 mv_Ap (C=2, K=1), fine level")

    # K2 on every level of the Jacobi hierarchy
    om = gmg.omega
    rec2 = records["scalar_jacobi_bf16c"]
    for op, lv in zip(pst.ops, pst.mvs):
        if lv.coef.dtype != bf16:
            raise RuntimeError("GMG(coef_dtype='bf16'): level not bfloat16")
        lv = SK.ScalarLevel(op, coef_dtype=bf16, resident=False,
                            slab=False)  # K2
        n = int(np.prod(lv.L))
        b, u = rnd(n), rnd(n)
        lv32 = wide(lv, op)
        for mode in (SK.MODE_INIT, SK.MODE_RESIDUAL, SK.MODE_SMOOTH):
            got = SK.scalar_jacobi(lv.coef, b, u, om, mode, lv.L)
            same(f"K2 {lv.L} mode {mode}", [got],
                 [SK.scalar_jacobi(lv32.coef, b, u, om, mode, lv.L)])
            rec2.compare(f32, f"K2 bf16 {lv.L} mode {mode}", got,
                         SK.scalar_jacobi_plain(lv.coef, b, u, om, mode,
                                                lv.L))
        for n_sweep in (2, 12):
            hooks = (("presmooth+residual",
                      lambda l_: l_.presmooth_residual(b, om, n_sweep),
                      (None, n_sweep, True)),
                     ("postsmooth",
                      lambda l_: (l_.postsmooth(u, b, om, n_sweep), None),
                      (u, n_sweep, False)),
                     ("sweep_n", lambda l_: (l_.sweep_n(b, om, n_sweep), None),
                      (None, n_sweep, False)))
            for what, hook, (u0, ns, res) in hooks:
                ref = SK.scalar_jacobi_phase_plain(lv.coef, b, u0, om, ns,
                                                   res, lv.L)
                got = hook(lv)
                same(f"K2 {lv.L} {what} x{n_sweep}", got, hook(lv32))
                rec2.compare(f32, f"K2 bf16 {lv.L} {what} x{n_sweep}",
                             torch.stack([g for g in got if g is not None]),
                             torch.stack([g for g in ref if g is not None]))
        if op is pst.ops[0]:
            rec2.set_work([lv.coef, b, u, b], 18 * n)
            timings(rec2, lambda: lv.smooth(u, b, om),
                    lambda: lv32.smooth(u, b, om),
                    lambda: SK.scalar_jacobi_plain(lv.coef, b, u, om,
                                                   SK.MODE_SMOOTH, lv.L),
                    "K2 bf16 smooth, fine level")
    del pst

    # K4 on every level of the Chebyshev hierarchy
    rec4 = records["scalar_chebyshev_bf16c"]
    pst = StencilCPR(gmg=GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384,
                             smoother="chebyshev",
                             coef_dtype="bf16")).update(A)
    for op, steps in zip(pst.ops, pst.cheb):  # the K4 chain
        lv = SK.ScalarLevel(op, coef_dtype=bf16, resident=False,
                            slab=False)
        n = int(np.prod(lv.L))
        b, u, d = rnd(n), rnd(n), rnd(n)
        lv32 = wide(lv, op)

        def step(fn, coef, k, mode):
            return fn(coef, b, u, d, steps, k, mode, lv.L)

        for mode, k in ((SK.CHEB_ZERO, 0), (SK.CHEB_FIRST, 0),
                        (SK.CHEB_STEP, 1), (SK.CHEB_STEP, 11)):
            got = step(SK.scalar_chebyshev, lv.coef, k, mode)
            same(f"K4 {lv.L} mode {mode} step {k}", got,
                 step(SK.scalar_chebyshev, lv32.coef, k, mode))
            rec4.compare(f32, f"K4 bf16 {lv.L} mode {mode} step {k}",
                         torch.stack(got), torch.stack(step(
                             SK.scalar_chebyshev_plain, lv.coef, k, mode)))
        for n_sweep in (2, 12):
            for what, hook in (
                    ("presmooth+residual", lambda l_:
                     l_.presmooth_residual_cheby(b, steps, n_sweep)),
                    ("postsmooth", lambda l_:
                     (l_.postsmooth_cheby(u, b, steps, n_sweep),)),
                    ("sweep_n", lambda l_:
                     (l_.sweep_n_cheby(b, steps, n_sweep),))):
                same(f"K4 {lv.L} {what} x{n_sweep}", hook(lv), hook(lv32))
        if op is pst.ops[0]:
            rec4.set_work([lv.coef, b, u, d, steps[1], u, d], 21 * n)
            timings(rec4,
                    lambda: step(SK.scalar_chebyshev, lv.coef, 1,
                                 SK.CHEB_STEP),
                    lambda: step(SK.scalar_chebyshev, lv32.coef, 1,
                                 SK.CHEB_STEP),
                    lambda: step(SK.scalar_chebyshev_plain, lv.coef, 1,
                                 SK.CHEB_STEP),
                    "K4 bf16 step, fine level")
    del B, A, pst
    torch.cuda.empty_cache()
    log("  bf16 entries = f32 entries on rounded coefficients, bitwise, on "
        "every level, mode and hook")


def _resident_hooks(SK, lv, form, cheby, b, u, om, steps, n_sweep):
    """The three phase hooks of a level at ``n_sweep`` sweeps: (name,
    K8/K9 in ``form`` -> (u, r or None), the hook of a level ``l_`` ->
    (u, r or None), from u, residual). K8/K9 is called through its wrapper,
    so that every hook runs on it whatever ``RESIDENT_HOOKS`` routes."""
    def k(u0, res):
        if cheby:
            return lambda: SK.scalar_chebyshev_resident(
                lv.coef, b, u0, steps, n_sweep, res, lv.L, form)
        return lambda: SK.scalar_sweeps_resident(lv.coef, b, u0, om, n_sweep,
                                                 res, lv.L, form)
    if cheby:
        return (("presmooth_residual_cheby", k(None, True),
                 lambda l_: l_.presmooth_residual_cheby(b, steps, n_sweep),
                 False, True),
                ("postsmooth_cheby", k(u, False), lambda l_: (
                    l_.postsmooth_cheby(u, b, steps, n_sweep), None), True,
                 False),
                ("sweep_n_cheby", k(None, False), lambda l_: (
                    l_.sweep_n_cheby(b, steps, n_sweep), None), False, False))
    return (("presmooth_residual", k(None, True),
             lambda l_: l_.presmooth_residual(b, om, n_sweep), False, True),
            ("postsmooth", k(u, False), lambda l_: (
                l_.postsmooth(u, b, om, n_sweep), None), True, False),
            ("sweep_n", k(None, False), lambda l_: (
                l_.sweep_n(b, om, n_sweep), None), False, False))


def kernel_checks_resident(case, records):
    """K8 (Jacobi) and K9 (Chebyshev) on every level of the well flagship's
    GMG hierarchies that they hold (the mid level in the grid form, the
    coarse one in the cluster form), float32 and float64 vectors and
    bfloat16 coefficients: every phase hook at 2 and 12 sweeps, called
    through the wrapper in the level's form, is one launch, equal bit for
    bit to the chain it replaces (K2's, K4's and K2's residual:
    ``ScalarLevel(resident=False)``) and within REL_TOL of the plain
    version; and the V-cycle's level hooks route as ``RESIDENT_HOOKS``
    says. Then the V-cycle's hooks (mid: presmooth+residual and postsmooth
    at 2 sweeps; coarse: the 12-sweep solve) timed in turns with the chain
    (K8/K9, chain, chain, K8/K9) as CUDA-graph replays, eager ms of each,
    the plain version and the hook's bound (7 coefficient streams, b and u
    in where given, u and r out where made, once, over 3.35 TB/s); ``routed`` says which ones the V-cycle takes."""
    from jutul.jl_tpu_torch import compile_model, from_numpy
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
    from jutul.jl_tpu_torch.ops.stencil import GMG, StencilCPR
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    model, state0, params, forces = case
    eng = BorderedStencilModel(compile_model(model), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    for dtype in (torch.float32, torch.float64):
        full = merge_state(from_numpy(state0, "cuda", dtype),
                           from_numpy(params, "cuda", dtype))
        _, B, _ = eng.assemble(full, full, DT, forces)
        for cd, smoother in ((None, "jacobi"), (None, "chebyshev"),
                             ("bf16", "jacobi"), ("bf16", "chebyshev")):
            if cd and dtype == torch.float64:
                continue  # bfloat16 coefficients: float32 vectors only
            cheby = smoother == "chebyshev"
            gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384,
                      smoother=smoother, coef_dtype=cd)
            pst = StencilCPR(gmg=gmg).update(B.A)
            wrapper = SK.scalar_chebyshev_resident if cheby else \
                SK.scalar_sweeps_resident
            name = (K9 if cheby else K8) + ("_bf16c" if cd else "")
            counter = "launches_bf16c" if cd else "launches"
            rec = records[name]
            rec.extra.setdefault("levels", [])
            om = gmg.omega
            tables = pst.cheb or [None] * len(pst.ops)
            for op, lv, steps in zip(pst.ops, pst.mvs, tables):
                n = op.n
                b, u = (torch.randn(n, generator=gen, device="cuda",
                                    dtype=dtype) for _ in range(2))
                plan = lv.plan(b)
                if plan is None:
                    continue
                chain = SK.ScalarLevel(op, coef_dtype=gmg.coef_torch_dtype(),
                                       resident=False, slab=False)

                def plain(u0, n_sweep, res):
                    if cheby:
                        return SK.scalar_chebyshev_resident_plain(
                            lv.coef, b, u0, steps, n_sweep, res, lv.L)
                    return SK.scalar_sweeps_resident_plain(
                        lv.coef, b, u0, om, n_sweep, res, lv.L)

                for n_sweep in (2, 12):
                    for what, k_call, hook, from_u, res in _resident_hooks(
                            SK, lv, plan[0], cheby, b, u, om, steps,
                            n_sweep):
                        tag = f"{name} {lv.L} {plan[0]} {what} x{n_sweep}"
                        before = getattr(wrapper, counter)
                        got = k_call()
                        if getattr(wrapper, counter) != before + 1:
                            raise RuntimeError(f"{tag}: not one launch")
                        want = hook(chain)
                        routed = SK.RESIDENT_HOOKS[plan[0]][what]
                        before = getattr(wrapper, counter)
                        via = hook(lv)
                        if getattr(wrapper, counter) != before + routed:
                            raise RuntimeError(f"{tag}: the level hook "
                                               "does not route as "
                                               "RESIDENT_HOOKS says")
                        for g_, w_, v_ in zip(got, want, via):
                            if (g_ is None) != (w_ is None) or (
                                    g_ is not None and not (torch.equal(
                                        g_, w_) and torch.equal(v_, w_))):
                                raise RuntimeError(
                                    f"{tag} [{dtype}]: differs from the "
                                    "chain it replaces")
                        ref = plain(u if from_u else None, n_sweep, res)
                        rec.compare(dtype, tag, torch.stack(
                            [g_ for g_ in got if g_ is not None]),
                            torch.stack([r_ for r_ in ref
                                         if r_ is not None]))
                if dtype != torch.float32:
                    continue
                last = op is pst.ops[-1]
                csize = 2 if cd else 4
                for what, k_call, hook, from_u, res in _resident_hooks(
                        SK, lv, plan[0], cheby, b, u, om, steps,
                        12 if last else 2):
                    if last != what.startswith("sweep_n"):
                        continue  # the hooks the V-cycle calls here
                    k_ms, c_ms, turns = _in_turns(k_call,
                                                  lambda: hook(chain))
                    nbytes = (7 * csize + 4 * (2 + from_u + res)) * n
                    row = {"L": list(lv.L), "plan": list(plan),
                           "coef": cd or "f32", "hook": what,
                           "n_sweep": 12 if last else 2,
                           "routed": SK.RESIDENT_HOOKS[plan[0]][what],
                           "graph_ms": k_ms, "chain_graph_ms": c_ms,
                           "graph_ms_turns_k_chain_chain_k": turns,
                           "eager_ms": cuda_ms(k_call),
                           "chain_eager_ms": cuda_ms(lambda: hook(chain)),
                           "plain_ms": cuda_ms(lambda: plain(
                               u if from_u else None, 12 if last else 2,
                               res), reps=5),
                           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           "bound_bytes": nbytes}
                    row["share_of_bound"] = row["bound_ms"] / k_ms
                    log(f"  {name} {lv.L} {what}: " + json.dumps(row))
                    rec.extra["levels"].append(row)
                    if last:  # the record's timed call: the coarse solve
                        rec.ms, rec.graph_ms = row["eager_ms"], k_ms
                        rec.plain_ms = row["plain_ms"]
                        rec.extra["chain_graph_ms"] = c_ms
                        rec.extra["timed"] = f"{what} x12, level {lv.L}"
                        # coefficients and b in, u out; ~17 flops a cell
                        # and sweep
                        rec.bytes, rec.ops = nbytes, 17 * 12 * n
            del pst
        del B
        torch.cuda.empty_cache()
    log("  K8/K9 = the K2/K4 chains on the card, bitwise, on every level "
        "and hook they hold")


SLAB_HOOKS = ("presmooth_residual", "postsmooth", "sweep_n")
SLAB_CHEBY_HOOKS = ("presmooth_residual_cheby", "postsmooth_cheby",
                    "sweep_n_cheby")


def kernel_checks_slab(case, records, cheby=False):
    """K10 (``cheby``: K11) on every level of the well flagship's Jacobi
    (Chebyshev) GMG hierarchy that ``ScalarLevel`` routes to it (the fine
    (64, 64, 256) and mid (32, 32, 128) levels: at least
    ``SLAB_MIN_CELLS`` cells), float32 and float64 vectors and bfloat16
    coefficients, every phase hook through the routed level: for K10
    presmooth+residual and postsmooth at 1-3 sweeps and sweep_n at 2 and
    12, in ``phase_chunks``' launches; for K11 presmooth+residual and
    postsmooth at 1-3 steps, one launch up to the level's depth (2) and the
    K4 chain beyond. Each equal bit for bit to the chain it replaces (K2's;
    K4's and K2's residual: ``ScalarLevel(resident=False, slab=False)``)
    and within REL_TOL of the plain version. Then the V-cycle's two hooks
    at 2 sweeps on each level timed in turns with the chain (kernel, chain,
    chain, kernel) as CUDA-graph replays, beside K8's (K9's) grid form
    where the level fits it, eager ms (20 calls back to back) of the
    kernel and the chain, the plain version and the hook's bound (7
    coefficient streams, b and u in where given, u and r out where made,
    once, over 3.35 TB/s).

    K10's checks run twice: through the default GMG (the reference's B2;
    timed, rows ``levels``) and through one with ``gmg.slab_double_buffer
    = True`` (B8's route, untimed), whose every level and hook must route
    as the default's."""
    from jutul.jl_tpu_torch import compile_model, from_numpy
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
    from jutul.jl_tpu_torch.ops.stencil import GMG, StencilCPR
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    model, state0, params, forces = case
    eng = BorderedStencilModel(compile_model(model), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11 if cheby else 10)
    kernel = K11 if cheby else K10
    hooks = SLAB_CHEBY_HOOKS if cheby else SLAB_HOOKS
    for dtype in (torch.float32, torch.float64):
        full = merge_state(from_numpy(state0, "cuda", dtype),
                           from_numpy(params, "cuda", dtype))
        _, B, _ = eng.assemble(full, full, DT, forces)
        like = torch.empty(0, dtype=dtype, device="cuda")
        for cd in (None, "bf16"):
            if cd and dtype == torch.float64:
                continue  # bfloat16 coefficients: float32 vectors only
            name = kernel + ("_bf16c" if cd else "")
            rec = records[name]
            default_routes = None
            # K10 again on B8's route (the flag changes no route), untimed
            for b8 in (False, True) if not cheby else (False,):
                gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384,
                          coef_dtype=cd,
                          smoother="chebyshev" if cheby else "jacobi")
                gmg.slab_double_buffer = b8
                pst = StencilCPR(gmg=gmg).update(B.A)
                routes = [[lv.route(h, like) for h in hooks]
                          for lv in pst.mvs]
                if b8 and routes != default_routes:
                    raise RuntimeError(f"{name}: B8's route {routes} differs "
                                       f"from the default's {default_routes}")
                default_routes = routes
                _slab_levels(SK, pst, gmg, dtype, gen, rec,
                             f"{'B8 ' if b8 else ''}{name}", cheby,
                             timed=not b8)
                del pst
        del B
        torch.cuda.empty_cache()
    log(f"  {'K11 = the K4 chain' if cheby else 'K10 = the K2 chain'} on "
        "the card, bitwise, on the fine and mid levels, every hook" +
        ("" if cheby else ", on the default route and on B8's"))


def _slab_levels(SK, pst, gmg, dtype, gen, rec, name, cheby, timed):
    """``kernel_checks_slab``'s checks and, ``timed``, timings on the
    levels of ``pst`` that route to K10 (``cheby``: K11); raises unless the
    fine and the mid level do. Timed rows go to ``rec.extra["levels"]``; the fine
    level's presmooth+residual is ``rec``'s timed call."""
    om = gmg.omega
    wrapper = SK.scalar_chebyshev_slab if cheby else SK.scalar_jacobi_slab
    counter = "launches_bf16c" if gmg.coef_dtype == "bf16" else "launches"
    suffix = "_cheby" if cheby else ""
    routed = 0
    tables = pst.cheb or [None] * len(pst.ops)
    for op, lv, steps in zip(pst.ops, pst.mvs, tables):
        n = op.n
        b, u = (torch.randn(n, generator=gen, device="cuda", dtype=dtype)
                for _ in range(2))
        if lv.route("presmooth_residual" + suffix, b) != "slab":
            continue
        routed += 1
        chain = SK.ScalarLevel(op, coef_dtype=gmg.coef_torch_dtype(),
                               resident=False, slab=False)
        if cheby:
            hooks = [(f"presmooth_residual_cheby x{k}", None, k, True,
                      lambda l_, k=k: l_.presmooth_residual_cheby(
                          b, steps, k)) for k in (1, 2, 3)]
            hooks += [(f"postsmooth_cheby x{k}", u, k, False,
                       lambda l_, k=k: (l_.postsmooth_cheby(u, b, steps, k),
                                        None)) for k in (1, 2, 3)]
        else:
            hooks = [(f"presmooth_residual x{k}", None, k, True,
                      lambda l_, k=k: l_.presmooth_residual(b, om, k))
                     for k in (1, 2, 3)]
            hooks += [(f"postsmooth x{k}", u, k, False,
                       lambda l_, k=k: (l_.postsmooth(u, b, om, k), None))
                      for k in (1, 2, 3)]
            hooks += [(f"sweep_n x{k}", None, k, False,
                       lambda l_, k=k: (l_.sweep_n(b, om, k), None))
                      for k in (2, 12)]

        def plain(u0, k, res):
            if cheby:
                return SK.scalar_chebyshev_slab_plain(lv.coef, b, u0, steps,
                                                      k, res, lv.L)
            return SK.scalar_jacobi_slab_plain(lv.coef, b, u0, om, k, res,
                                               lv.L)

        for what, u0, k, res, hook in hooks:
            tag = f"{name} {lv.L} {what}"
            if cheby:  # one launch up to the depth; d cannot cross launches
                want = int(SK._phase_depth(u0, k, res) <= lv.depth)
            else:
                want = len(SK.phase_chunks(k, u0 is None, res, lv.depth))
            before = getattr(wrapper, counter)
            got = hook(lv)
            if getattr(wrapper, counter) != before + want:
                raise RuntimeError(f"{tag}: not {want} launches")
            for g_, w_ in zip(got, hook(chain)):
                if (g_ is None) != (w_ is None) or (
                        g_ is not None and not torch.equal(g_, w_)):
                    raise RuntimeError(f"{tag} [{dtype}]: differs from the "
                                       f"{'K4' if cheby else 'K2'} chain")
            ref = plain(u0, k, res)
            rec.compare(dtype, tag, torch.stack(
                [g_ for g_ in got if g_ is not None]),
                torch.stack([r_ for r_ in ref if r_ is not None]))
        if dtype != torch.float32 or not timed:
            continue
        csize = 2 if lv.coef.dtype == torch.bfloat16 else 4
        grid = SK.resident_plan(lv.L, dtype, lv.coef.dtype,
                                SK.device_props(b.device, dtype,
                                                lv.coef.dtype), "grid")
        for what, u0, k, res, hook in hooks:
            if k != 2 or what.startswith("sweep_n"):
                continue  # the hooks the V-cycle calls here
            k_ms, c_ms, turns = _in_turns(lambda: hook(lv),
                                          lambda: hook(chain))
            from_u = u0 is not None
            nbytes = (7 * csize + 4 * (2 + from_u + res)) * n
            row = {"L": list(lv.L), "coef": "bf16" if csize == 2 else "f32",
                   "hook": what,
                   "plan": list(SK.slab_plan(
                       lv.L, dtype, lv.coef.dtype,
                       SK._phase_depth(u0, k, res), from_u, cheby=cheby)),
                   "graph_ms": k_ms, "chain_graph_ms": c_ms,
                   "graph_ms_turns_k_chain_chain_k": turns,
                   "eager_ms": cuda_ms(lambda: hook(lv)),
                   "chain_eager_ms": cuda_ms(lambda: hook(chain)),
                   "plain_ms": cuda_ms(lambda: plain(u0, k, res), reps=5),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_bytes": nbytes}
            if grid is not None:
                row["k9_grid_graph_ms" if cheby else "k8_grid_graph_ms"] = \
                    graph_ms(lambda: (SK.scalar_chebyshev_resident(
                        lv.coef, b, u0, steps, k, res, lv.L, "grid")
                        if cheby else SK.scalar_sweeps_resident(
                            lv.coef, b, u0, om, k, res, lv.L, "grid")))
            row["share_of_bound"] = row["bound_ms"] / k_ms
            log(f"  {name} {lv.L} {what}: " + json.dumps(row))
            rec.extra.setdefault("levels", []).append(row)
            if op is pst.ops[0] and res:
                # the record's timed call: the fine level's
                # presmooth+residual; ~17 flops a cell and application for
                # a Jacobi sweep, ~20 for a Chebyshev step
                rec.ms, rec.graph_ms = row["eager_ms"], k_ms
                rec.plain_ms = row["plain_ms"]
                rec.extra["chain_graph_ms"] = c_ms
                rec.extra["timed"] = f"{what}, level {lv.L}"
                rec.bytes, rec.ops = nbytes, (20 if cheby else 17) * 2 * n
    if routed != 2:
        raise RuntimeError(f"{name}: {routed} levels route to "
                           f"{'K11' if cheby else 'K10'}, the flagship's fine "
                           "and mid expected")


def kernel_checks_transpose(case, records):
    """K1 on the adjoint's transposed lattice operator (``stencil_transpose``
    of the well flagship's assembled matrix: every field a non-contiguous
    view, which ``embed`` packs) against its plain version and, bit for
    bit, its original mapping, in float32 and float64, and the dot
    identity <x, A y> = <Aᵀx, y> through K1 (sums in
    float64: 1e-5 relative at float32, 1e-12 at float64)."""
    from jutul.jl_tpu_torch import compile_model, from_numpy
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
    from jutul.jl_tpu_torch.ops.stencil import stencil_transpose
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    model, state0, params, forces = case
    eng = BorderedStencilModel(compile_model(model), "cuda")
    rec = records["stencil_matvec"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype, dot_tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        full = merge_state(from_numpy(state0, "cuda", dtype),
                           from_numpy(params, "cuda", dtype))
        _, B, _ = eng.assemble(full, full, DT, forces)
        At = stencil_transpose(B.A)
        if At.diag.is_contiguous():
            raise RuntimeError("stencil_transpose: expected a view")
        mv, mv_t = SK.StencilMatvec(B.A), SK.StencilMatvec(At)
        if not mv_t.coef.is_contiguous():
            raise RuntimeError("embed left the transposed blocks unpacked")
        x, y = (torch.randn((B.A.n, 2), generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
        aty = mv_t(x)
        rec.compare(dtype, "K1 transposed C=K=2", aty,
                    SK.stencil_matvec_plain(mv_t.coef, x, mv_t.L, 2, 2))
        k1_entry(f"transposed C=K=2 [{dtype}]", mv_t, x, timed=False)
        lhs = float(torch.sum((x * mv(y)).double()))
        rhs = float(torch.sum((aty * y).double()))
        rel = abs(lhs - rhs) / abs(lhs)
        log(f"  K1 dot identity [{dtype}]: <x, A y> {lhs:.9e}, "
            f"<A^T x, y> {rhs:.9e}, rel {rel:.3e}")
        if not rel <= dot_tol:
            raise RuntimeError(f"K1 transposed: dot identity off by {rel:.3e}"
                               f" > {dot_tol:.0e} [{dtype}]")
        rec.extra[f"transposed_dot_identity_rel_{str(dtype)[6:]}"] = rel
        if dtype == torch.float32:
            rec.extra["transposed_graph_ms"] = graph_ms(lambda: mv_t(x))
        del B, At, mv, mv_t
        torch.cuda.empty_cache()


def kernel_checks_krylov(records):
    """K6/K7 at the Schur system's 2 x 1,048,576 values against their
    plain versions, and against a second call on the same inputs, bitwise
    (the sums have a fixed order)."""
    from jutul.jl_tpu_torch.ops.cuda import krylov_kernels as KK

    n = 2 * GRID[0] * GRID[1] * GRID[2]
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.float64):
        log(f"# K6/K7 vs plain, {dtype}, n={n}")
        vec = lambda: torch.randn(n, generator=gen, device="cuda",  # noqa: E731
                                  dtype=dtype)
        rhat, r, v = vec(), vec(), vec()
        rho = torch.dot(rhat, r)
        s, alpha = KK.fused_alpha_s(rhat, r, v, rho)
        s_p, alpha_p = KK.fused_alpha_s_plain(rhat, r, v, rho)
        rec6 = records["fused_alpha_s"]
        rec6.compare(dtype, "K6 s", s, s_p)
        rec6.compare(dtype, "K6 alpha", alpha, alpha_p)
        s2, alpha2 = KK.fused_alpha_s(rhat, r, v, rho)
        if not (torch.equal(s, s2) and torch.equal(alpha, alpha2)):
            raise RuntimeError("K6: a second call on the same inputs differs")
        t, phat, shat, x, p = (vec() for _ in range(5))
        args = (rhat, t, s, phat, shat, x, p, v, rho, alpha)
        got = KK.fused_omega_update(*args)
        ref = KK.fused_omega_update_plain(*args)
        rec7 = records["fused_omega_update"]
        for name, g, w in zip(("x", "r", "p", "omega", "rho", "res2"), got,
                              ref):
            rec7.compare(dtype, f"K7 {name}", g, w)
        again = KK.fused_omega_update(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError("K7: a second call on the same inputs differs")
        log("  K6/K7: second calls bitwise equal")
        if dtype == torch.float32:
            rec6.set_work([rhat, r, v, s], 4 * n)
            rec7.set_work([rhat, t, s, phat, shat, x, p, v] + list(got[:3]),
                          18 * n)
            for rec, fn, plain in (
                    (rec6, lambda: KK.fused_alpha_s(rhat, r, v, rho),
                     lambda: KK.fused_alpha_s_plain(rhat, r, v, rho)),
                    (rec7, lambda: KK.fused_omega_update(*args),
                     lambda: KK.fused_omega_update_plain(*args))):
                rec.ms = cuda_ms(fn)
                rec.graph_ms = graph_ms(fn)
                rec.plain_ms = cuda_ms(plain)
        torch.cuda.empty_cache()


def phase_warm_up():
    """Every slice's path at 16x16x8 (the MultiModel's: one step at 8x8x6)
    in float32 on the card, 2 report
    steps: the first use of each PyTorch op in a process loads its CUDA
    module (~12 s for the wells path), which the timed slices should not
    measure."""
    from jutul.jl_tpu_torch import Simulator

    t0 = time.perf_counter()
    for build, smoother, fused in ((build_flagship, "jacobi", False),
                                   (build_well_flagship, "chebyshev", False),
                                   (build_well_flagship, "jacobi", True)):
        model, state0, params, forces = build(*SMALL)
        Simulator(model, state0, params, use_stencil=True,
                  device="cuda").simulate(
            [DT] * 2, forces=rate_schedule(forces, 2),
            **sim_config(64, smoother, fused))
    model, state0, params, forces = build_well_flagship(*SMALL)
    for coef_dtype in (None, "bf16"):
        sim = Simulator(model, state0, params, use_stencil=True,
                        device="cuda")
        res = sim.simulate_jit(
            [DT] * 2, forces=rate_schedule(forces, 2),
            **sim_config(64, coef_dtype=coef_dtype, product=True))
    refine(sim, res, forces, 2, budget_s=20.0)
    model, state0, params, forces = build_flagship(*SMALL)
    for product in (False, True):
        sim = Simulator(model, state0, params, use_stencil=False)
        run = sim.simulate_jit if product else sim.simulate
        run([DT] * 2, forces=rate_schedule(forces, 2),
            **generic_config(product=product))
    warm_up_multimodel()
    log(f"# warm-up (every slice's path at 16x16x8): "
        f"{time.perf_counter() - t0:.1f} s")


def warm_up_multimodel():
    """The MultiModel's path: one step at 8x8x6 on the card."""
    from jutul.jl_tpu_torch import Simulator

    mm, state0, params, forces = build_well_multimodel(*WELL_SMALL_EW)
    Simulator(mm, state0, params).simulate_jit(
        [DT], forces=rate_schedule(forces, 2)[:1],
        **multimodel_config(product=True))
    torch.cuda.synchronize()


GMG_LEVEL_KERNELS = ("scalar_jacobi", "scalar_chebyshev", K8, K9, K10, K11)


def level_launches_per_vcycle(L, smoother, coef_dtype=None, n_smooth=2,
                              n_coarse=12, min_cells=16384, props=None):
    """The GMG level kernels' launches in one V-cycle of the flagship's
    pressure hierarchy on ``L`` (nz, ny, nx), as ``ScalarLevel`` routes it
    (``level_route``) on a card with ``props`` (None: this card's): a
    "resident" hook is one K8/K9 launch, a "slab" hook the K10 launches of
    ``phase_chunks`` or one K11 launch (a V-cycle phase never exceeds the
    level's depth), a "chain" K2 one pass per sweep and residual, or K4 one
    step per launch and K2's residual after a Chebyshev presmooth.
    ``GMG.slab_double_buffer`` changes no route. Keys as
    ``launch_counts``."""
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK

    cd = torch.bfloat16 if coef_dtype == "bf16" else None
    sfx = "_bf16c" if cd is not None else ""
    if props is None:
        props = SK.device_props(torch.device("cuda", 0), torch.float32, cd)
    depth = min(max(n_smooth, 2), SK.SLAB_MAX_DEPTH)
    shapes = [tuple(L)]
    while int(np.prod(shapes[-1])) > min_cells:
        shapes.append(tuple(v if v == 1 else -(-v // 2) for v in shapes[-1]))
    out = dict.fromkeys((k + sfx for k in GMG_LEVEL_KERNELS), 0)
    cheby = smoother == "chebyshev"
    for i, shape in enumerate(shapes):
        last = i == len(shapes) - 1
        names = (["sweep_n"] if last else ["presmooth_residual",
                                           "postsmooth"])
        for h in names:
            n_sweep = n_coarse if last else n_smooth
            res = h == "presmooth_residual"
            hook = h + "_cheby" if cheby else h
            route = SK.level_route(shape, hook, torch.float32, cd, props,
                                   depth=depth)
            if route == "resident":
                out[(K9 if cheby else K8) + sfx] += 1
            elif route == "slab" and cheby:
                out[K11 + sfx] += 1
            elif cheby:
                out["scalar_chebyshev" + sfx] += n_sweep
                out["scalar_jacobi" + sfx] += res
            elif route == "slab":
                out[K10 + sfx] += len(SK.phase_chunks(
                    n_sweep, h != "postsmooth", res, depth))
            else:
                out["scalar_jacobi" + sfx] += n_sweep + res
    return out


def check_level_launches(name, launches, lin, smoother, coef_dtype):
    """The level kernels' launches of a slice at GRID: two V-cycles per
    linear iteration (BiCGStab applies CPR twice), each as
    ``level_launches_per_vcycle`` routes it; raises on any other count.
    Returns the expected launches per linear iteration."""
    per = level_launches_per_vcycle((GRID[2], GRID[1], GRID[0]), smoother,
                                    coef_dtype)
    got = {k: launches[k] for k in per}
    want = {k: 2 * v * lin for k, v in per.items()}
    if got != want:
        raise RuntimeError(f"{name} slice: GMG level launches {got}, "
                           f"routing expects {want} ({lin} linear "
                           "iterations)")
    return {k: 2 * v for k, v in per.items()}


def phase_slice(case, name, smoother, fused=False, product=False,
                coef_dtype=None, phases=None, n_step=3):
    """One slice at full size in float32, ``n_step`` report steps; the
    kernels of ``SLICE_KERNELS[name]`` must launch in it, those of
    ``SLICE_FORBIDDEN[name]`` never; with ``fused``, K6 and K7 launch once
    per linear iteration. ``product``: through the schedule path as
    bench.py's run_product calls it — ``lower_schedule`` (timed apart: the
    set-up), then ``post(*run(*args))`` — instead of the eager ``simulate``;
    ``phases``: ``gmg.slab_double_buffer`` (B8's route) whatever ``fused``
    says."""
    from jutul.jl_tpu_torch import Simulator, report_stats
    from jutul.jl_tpu_torch.ops.cuda import (
        launch_counts,
        reset_launch_counts,
        stencil_matvec,
    )

    model, state0, params, forces = case
    nc = model.number_of_cells()
    sim = Simulator(model, state0, params, use_stencil=True)  # the card
    schedule = rate_schedule(forces, n_step)
    cfg = sim_config(16384, smoother, fused, coef_dtype, product)
    if phases is not None:
        cfg["linear_solver"].preconditioner.gmg.slab_double_buffer = phases
    setup_s = None
    if product:
        t0 = time.perf_counter()
        run, args, post = sim.lower_schedule([DT] * n_step, forces=schedule,
                                             **cfg)
        setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    if product:
        res = post(*run(*args))
    else:
        res = sim.simulate([DT] * n_step, forces=schedule, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    k1_shapes = {f"{e} C={c} K={k}": v for (e, c, k), v in
                 stencil_matvec.launches_by_shape.items()}
    stats = report_stats(res.reports)
    peak = torch.cuda.max_memory_allocated()
    if not all(r["success"] for r in res.reports) or \
            len(res.reports) != n_step:
        raise RuntimeError(f"{name} slice: a report step failed")
    for k, v in res.states[-1].items():
        if not np.all(np.isfinite(v)):
            raise RuntimeError(f"{name} slice: final {k} not finite")
    _check_launches(f"{name} slice", name, launches)
    newtons, lin = stats["newtons"], stats["linear_iterations"]
    if fused and not (launches["fused_alpha_s"] == lin
                      == launches["fused_omega_update"]):
        raise RuntimeError(f"{name} slice: K6/K7 launches {launches} differ "
                           f"from the {lin} linear iterations")
    level_per_lin = check_level_launches(name, launches, lin, smoother,
                                         coef_dtype)
    if coef_dtype == "bf16" and launches["stencil_matvec_bf16c"] != 2 * lin:
        # CPR's stage 2 runs once per preconditioner application, two per
        # linear iteration, and nothing else takes bfloat16 K1 coefficients
        raise RuntimeError(f"{name} slice: the bf16 stage-2 matvec launched "
                           f"{launches['stencil_matvec_bf16c']} times in "
                           f"{lin} linear iterations")
    out = {
        "slice": name, "smoother": smoother, "fused": fused, "cells": nc,
        "path": "schedule (lower_schedule, EW forcing)" if product
        else "eager (simulate, fixed rtol)", "coef_dtype": coef_dtype,
        "dtype": "float32", "report_steps": n_step,
        "ministeps": stats["ministeps"], "newtons": newtons,
        "failed_ministeps": stats["failed_ministeps"],
        "linear_iterations": lin,
        "wall_s": wall, "s_per_newton": wall / newtons,
        "cell_newton_its_per_s": nc * newtons / wall,
        "peak_mem_bytes": peak, "launches": launches,
        "launches_per_linear_iteration": {
            k: v / max(lin, 1) for k, v in launches.items()},
        # the GMG level kernels' launches per linear iteration as routed
        # (checked equal to the counts)
        "level_launches_per_linear_iteration": level_per_lin,
        # K1's launches by entry and shape: the operator (C = K = 2) and
        # CPR stage 2's pressure column (C = 2, K = 1) counted apart
        "k1_launches_by_shape": k1_shapes,
        # (Newtons, linear iterations) of each ministep: a ministep held at
        # the Newton cap shows the f32 roundoff floor of its residual
        "per_ministep": [[m["iterations"], m["linear_iterations"]]
                         for r in res.reports for m in r["ministeps"]],
    }
    if product:
        max_it = cfg["max_nonlinear_iterations"]
        out.update({
            "setup_s": setup_s,
            # the Newton loop's device->host reads: one per assembly
            # (each solve's, and each ministep's start state)
            "host_reads": sim.host_reads,
            "host_reads_per_newton": sim.host_reads / newtons,
            # the Krylov loop's own: one per iteration and one per solve
            "krylov_host_reads": lin + newtons,
            "newtons_in_capped_ministeps": sum(
                m["iterations"] for r in res.reports for m in r["ministeps"]
                if m["iterations"] >= max_it)})
        if sim.host_reads != newtons + stats["ministeps"]:
            raise RuntimeError(f"{name} slice: {sim.host_reads} Newton host "
                               f"reads for {newtons} solves in "
                               f"{stats['ministeps']} ministeps")
    log(f"# {name} slice: " + json.dumps(out))
    return sim, res, schedule[-1], out


def phase_k10_share(case, n_step=3):
    """K10's share of the eager main path: srcwells' slice (``n_step``
    report steps, float32, its solver settings) four times in turns in this
    process — as routed (K10 on the fine and mid levels), with those levels
    on the K2 chain (``SLAB_MIN_CELLS`` set above every level for the run),
    chain again, routed again — and the s/Newton of each route, the mean of
    its two runs. K10 is the K2 chain bit for bit, so every run must give
    the same counts in every ministep and the same final state; the routed
    runs launch K10 and no K2 pass, the chain runs no K10."""
    from jutul.jl_tpu_torch import Simulator, report_stats
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK

    model, state0, params, forces = case
    schedule = rate_schedule(forces, n_step)
    threshold = SK.SLAB_MIN_CELLS
    runs, first = [], None
    for route in ("routed", "chain", "chain", "routed"):
        sim = Simulator(model, state0, params, use_stencil=True)
        cfg = sim_config(16384)
        SK.SLAB_MIN_CELLS = threshold if route == "routed" else 2 ** 62
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            res = sim.simulate([DT] * n_step, forces=schedule, **cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            SK.SLAB_MIN_CELLS = threshold
        n = launch_counts()
        st = report_stats(res.reports)
        per = [[m["iterations"], m["linear_iterations"]]
               for r in res.reports for m in r["ministeps"]]
        if (n[K10] == 0 or n["scalar_jacobi"] != 0) if route == "routed" \
                else (n[K10] != 0 or n["scalar_jacobi"] == 0):
            raise RuntimeError(f"K10 share: the {route} run launched K10 "
                               f"{n[K10]}, K2 {n['scalar_jacobi']} times")
        if first is None:
            first = (per, res.states[-1])
        elif per != first[0] or any(
                not np.array_equal(v, first[1][k])
                for k, v in res.states[-1].items()):
            raise RuntimeError("K10 share: the runs differ: "
                               f"{per} against {first[0]}")
        runs.append({"route": route, "wall_s": wall,
                     "newtons": st["newtons"],
                     "s_per_newton": wall / st["newtons"],
                     "k10_launches": n[K10],
                     "k2_launches": n["scalar_jacobi"]})
        del sim, res
    mean = {r: sum(x["s_per_newton"] for x in runs if x["route"] == r) / 2
            for r in ("routed", "chain")}
    out = {"ministeps": len(first[0]), "newtons": runs[0]["newtons"],
           "linear_iterations": sum(p[1] for p in first[0]),
           "routed_s_per_newton": mean["routed"],
           "chain_s_per_newton": mean["chain"], "runs": runs}
    log("# K10 share (srcwells eager, routed / chain / chain / routed, same "
        "counts and state): " + json.dumps(out))
    return out


def refine(sim, res, forces, n_lin_it, budget_s=None):
    """``refine_solution`` on ``res``'s last accepted ministep with the
    bench's settings (bench.py:418-456): corrections at ``rtol=0`` over
    max(60, 2 n_lin_it) iterations, polish solver at ``rtol=1e-6``,
    ``tol=1e-8``, 8 sweeps, straight to the float64 polish at >= 512k
    cells. Everything on the simulator's device."""
    from jutul.jl_tpu_torch import GMG, StencilCPR, StencilKrylovSolver

    def solver(rtol):
        return StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=GMG(
                n_smooth=2, n_coarse_sweeps=12, min_cells=16384)),
            rtol=rtol, max_iterations=max(60, 2 * n_lin_it))

    prim = sim.model.primary_variables
    final = {k: res.final_state_device[k] for k in prim}
    start = {k: res.final_ministep_start_state[k] for k in prim}
    nc = final["Pressure"].shape[0]
    phase0 = "f64" if nc >= 512 * 1024 else "auto"
    t0 = time.perf_counter()
    _, info = sim.refine_solution(
        final, start, res.final_ministep_dt, forces=forces, tol=1e-8,
        max_refine=8, solver=solver(0.0), f64_solver=solver(1e-6),
        info_level=1, phase0=phase0, time_budget_s=budget_s)
    torch.cuda.synchronize()
    return {**info, "phase0": phase0, "seconds": time.perf_counter() - t0}


def phase_refine(sim, res, forces):
    """The refinement of the wells-product slice's last accepted ministep
    toward max|r| <= 1e-8, on the card. Held to a finite final max|r| below
    the start's; reaching 1e-8 is reported."""
    torch.cuda.reset_peak_memory_stats()
    out = refine(sim, res, forces, 25, budget_s=240.0)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log("# refine (wells-product, last accepted ministep): "
        + json.dumps(out))
    hist = out["f64_residual_history"]
    if not (np.isfinite(out["f64_max_abs_residual"]) and len(hist) >= 2
            and out["f64_max_abs_residual"] < hist[0]):
        raise RuntimeError(f"refine: no gain over the start: {out}")
    return out


def _to64(tree):
    """float64 copies of a state's (or nested states') float tensors;
    integer tables keep their type."""
    return {k: _to64(v) if isinstance(v, dict)
            else v.double() if v.is_floating_point() else v
            for k, v in tree.items()}


def mm_f64_record(compiled, r, full, crit, dt):
    """The f64 verify's record of a MultiModel: CNV over every submodel's
    cells; MB the balance of the whole coupled system (the perforations
    cancel in it), as the well-graph model's global MB."""
    num = den = 0.0
    for m, c in compiled.comps.items():
        info = next(i for i in c.equations if i.name == "mass_conservation")
        n_, d_ = info.eq.convergence_parts(
            c.model, info.name, r[m][:, info.row_slice], full[m],
            dt)["MB"][1]
        num, den = num + n_, den + d_
    return {"rows": sum(x.shape[0] for x in r.values()),
            "f64_max_abs_residual": max(float(x.abs().max())
                                        for x in r.values()),
            "f64_CNV": max(float(crit[f"{m}.mass_conservation"]["CNV"]
                                 .max()) for m in r),
            "f64_MB": float((num.abs() / den).max()),
            "f64_MB_by_model": {m: float(
                crit[f"{m}.mass_conservation"]["MB"].max()) for m in r}}


def phase_f64_verify(sim, res, forces, name):
    """The final accepted ministep re-assembled in float64 on the card,
    over every row (lattice and wellbore cells; for a MultiModel, CNV over
    every submodel's rows and MB of the whole coupled system)."""
    pr = _to64(sim.parameters)
    r, _, full = sim.engine.assemble(
        sim._merge(_to64(res.final_state_device), pr),
        sim._merge(_to64(res.final_ministep_start_state), pr),
        res.final_ministep_dt, forces)
    dt = res.final_ministep_dt
    crit = sim.compiled.convergence(r, full, dt)
    if isinstance(r, dict):
        out = mm_f64_record(sim.compiled, r, full, crit, dt)
    else:
        c = crit["mass_conservation"]
        out = {"rows": r.shape[0],
               "f64_max_abs_residual": float(r.abs().max()),
               "f64_CNV": float(c["CNV"].max()),
               "f64_MB": float(c["MB"].max())}
    log(f"# {name} f64 verify: " + json.dumps(out))
    if not (out["f64_CNV"] <= 10 * CNV_TOL and out["f64_MB"] <= 10 * MB_TOL):
        raise RuntimeError(f"{name} f64 verify: residual out of bound: {out}")
    return out


def phase_ab(case_small, n_step=3):
    """The well flagship at AB_GRID with Jacobi GMG on the card, float32,
    ``n_step`` report steps, in four runs: both opt-ins ("fused": the B8
    flag and the K6/K7 body), the B8 flag alone ("phases"), neither, and
    neither
    again from an initial pressure scaled by 1 + 2^-22 (two float32 ulps:
    "neither_perturbed").

    - "phases" against "neither" must match exactly — the same counts in
      every ministep, bitwise-equal states — because the flag routes
      every level as the default does (K10 on the 65,536-cell fine level,
      the K2 chain below it);
    - "fused" sums its dot products in another order than the plain chain,
      and on this float32 Schur system Krylov and Newton counts move with
      any roundoff: the "neither_perturbed" run shows how far. So "fused"
      is held to what its answer must satisfy — every report step
      succeeds and the final ministep passes the float64 verify — and its
      counts and state deviations are reported beside the perturbed run's."""
    from jutul.jl_tpu_torch import Simulator, report_stats

    model, state0, params, forces = case_small
    schedule = rate_schedule(forces, n_step)
    runs, out = {}, {"cells": model.number_of_cells()}
    for tag, fused, phases, scale in (
            ("fused", True, True, 1.0), ("phases", False, True, 1.0),
            ("neither", False, False, 1.0),
            ("neither_perturbed", False, False, 1.0 + 2.0 ** -22)):
        st0 = {**state0, "Pressure": state0["Pressure"] * scale}
        sim = Simulator(model, st0, params, use_stencil=True)
        cfg = sim_config(16384, "jacobi", fused)
        cfg["linear_solver"].preconditioner.gmg.slab_double_buffer = phases
        t0 = time.perf_counter()
        res = sim.simulate([DT] * n_step, forces=schedule, **cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(r["success"] for r in res.reports) or \
                len(res.reports) != n_step:
            raise RuntimeError(f"A/B {tag}: a report step failed")
        st = report_stats(res.reports)
        runs[tag] = res
        out[tag] = {k: st[k] for k in ("ministeps", "newtons",
                                       "linear_iterations")}
        out[tag]["wall_s"] = wall
        out[tag]["per_ministep"] = [[m["iterations"], m["linear_iterations"]]
                                    for r in res.reports
                                    for m in r["ministeps"]]
        if tag in ("fused", "neither"):
            out[tag]["f64_verify"] = phase_f64_verify(sim, res, schedule[-1],
                                                      f"A/B {tag}")
        del sim
    ref = runs["neither"].states
    for tag in ("fused", "phases", "neither_perturbed"):
        out[tag]["max_rel_dev_pressure"] = max(
            float(np.max(np.abs(a["Pressure"] / b["Pressure"] - 1)))
            for a, b in zip(runs[tag].states, ref))
        out[tag]["max_abs_dev_saturations"] = max(
            float(np.max(np.abs(a["Saturations"] - b["Saturations"])))
            for a, b in zip(runs[tag].states, ref))
    log(f"# A/B ({'x'.join(map(str, AB_GRID))}, f32, card): "
        + json.dumps(out))
    if out["phases"]["per_ministep"] != out["neither"]["per_ministep"] or \
            out["phases"]["max_rel_dev_pressure"] != 0.0 or \
            out["phases"]["max_abs_dev_saturations"] != 0.0:
        raise RuntimeError("A/B: the B8 flag changes the run: "
                           + json.dumps(out))
    return out


def phase_cross_check(build, dims, smoother, name, phases=False,
                      product=False):
    """The slice at ``dims`` in float64, 2 report steps, on the card and
    on the CPU: identical counts, states within 1e-9. ``phases``: B8's
    route (``slab_double_buffer``; the fused body is float32
    only and stays off). ``product``: through the schedule path with
    Eisenstat-Walker forcing (``simulate_jit``; its final state)."""
    from jutul.jl_tpu_torch import Simulator
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, params, forces = build(*dims)
    runs = {}
    for dev in ("cuda", "cpu"):
        sim = Simulator(model, state0, params, use_stencil=True, device=dev,
                        dtype=torch.float64)
        cfg = sim_config(64, smoother, product=product)
        cfg["linear_solver"].preconditioner.gmg.slab_double_buffer = phases
        run = sim.simulate_jit if product else sim.simulate
        reset_launch_counts()
        res = run([DT] * 2, forces=rate_schedule(forces, 2), **cfg)
        if dev == "cuda":
            launches = launch_counts()
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
    # the card run's kernel launches (every level here is under
    # SLAB_MIN_CELLS: the K2/K4 chains run it)
    out["launches"] = launches
    if not (dev_p <= 1e-9 and dev_s <= 1e-9):
        raise RuntimeError(f"{name} cross-check: states differ: {out}")
    return out


def phase_small_chains(dims=WELL_SMALL, n_step=2):
    """``wells-small-bf16-cheby``: wells-product-bf16-cheby's settings (the
    schedule path, bfloat16 level coefficients, the Chebyshev smoother) on
    the well model at ``dims`` in float32 on the card, ``n_step`` report
    steps, GMG down to 64 cells. Every level is under SLAB_MIN_CELLS, so
    the bfloat16 entries of the K4 and K2 chains run the smoothing phases
    and K9's the coarse solve (``SLICE_KERNELS``); every report step must
    succeed with a finite state."""
    from jutul.jl_tpu_torch import Simulator, report_stats
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    name = "wells-small-bf16-cheby"
    model, state0, params, forces = build_well_flagship(*dims)
    sim = Simulator(model, state0, params, use_stencil=True)  # the card
    cfg = sim_config(64, "chebyshev", coef_dtype="bf16", product=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.simulate_jit([DT] * n_step, forces=rate_schedule(forces, n_step),
                           **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if not all(r["success"] for r in res.reports) or \
            len(res.reports) != n_step or not all(
                np.all(np.isfinite(v)) for v in res.states[-1].values()):
        raise RuntimeError(f"{name}: a report step failed or a final state "
                           "is not finite")
    _check_launches(name, name, launches)
    stats = report_stats(res.reports)
    out = {"cells": int(np.prod(dims)), "report_steps": n_step,
           "ministeps": stats["ministeps"], "newtons": stats["newtons"],
           "linear_iterations": stats["linear_iterations"], "wall_s": wall,
           "launches": launches}
    log(f"# {name} ({'x'.join(map(str, dims))}, f32, bf16 coefficients): "
        + json.dumps(out))
    return out


def _check_launches(what, name, launches):
    """Raise unless every kernel of ``SLICE_KERNELS[name]`` launched and
    none of ``SLICE_FORBIDDEN[name]`` did."""
    missing = [k for k in SLICE_KERNELS[name] if launches[k] <= 0]
    stray = [k for k in SLICE_FORBIDDEN.get(name, ()) if launches[k]]
    if missing or stray:
        raise RuntimeError(f"{what}: never launched {missing}, launched "
                           f"{stray}: {launches}")


def phase_generic(case, n_step=3):
    """The generic block-ELL engine at full size in float32 on the card:
    ``Simulator(use_stencil=False)`` eager ``simulate`` of ``n_step`` 6 h
    report steps with srcwells' Newton settings and BASELINE.json's
    CPR(AMG + ILU(0))-GMRES (``generic_config``). The host set-up (the ELL
    structure and gather tables, the AMG hierarchy) is timed apart, before
    the run; no kernel of ops/cuda may launch. Afterwards one ``assemble``,
    one CPR ``update`` and one GMRES iteration are timed by CUDA events on
    the final ministep's system. Returns (sim, res, last forces, record)."""
    from jutul.jl_tpu_torch import Simulator, report_stats
    from jutul.jl_tpu_torch.linsolve.krylov import gmres
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, params, forces = case
    nc = model.number_of_cells()
    sim = Simulator(model, state0, params, use_stencil=False)  # the card
    schedule = rate_schedule(forces, n_step)
    cfg = generic_config()
    cpr = cfg["linear_solver"].preconditioner
    t0 = time.perf_counter()
    ell = sim.compiled.ell
    tables_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hier = cpr.amg._symbolic(ell)
    amg_s = time.perf_counter() - t0
    # the fine level's aggregation, native (as the hierarchy ran it)
    # against the numpy loop the port ran before it had the native library
    from jutul.jl_tpu_torch.linsolve import amg as AMG

    cols = np.asarray(ell.cols)
    t0 = time.perf_counter()
    agg = AMG.greedy_aggregate(cols, cols.shape[0])
    agg_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg_loop = AMG.greedy_aggregate_loop(cols, cols.shape[0])
    agg_loop_s = time.perf_counter() - t0
    if not np.array_equal(agg, agg_loop):
        raise RuntimeError("generic slice: native aggregates differ from "
                           "the loop's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.simulate([DT] * n_step, forces=schedule, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = report_stats(res.reports)
    if not all(r["success"] for r in res.reports) or \
            len(res.reports) != n_step:
        raise RuntimeError("generic slice: a report step failed")
    for k, v in res.states[-1].items():
        if not np.all(np.isfinite(v)):
            raise RuntimeError(f"generic slice: final {k} not finite")
    _check_launches("generic slice", "generic", launches)
    newtons, lin = stats["newtons"], stats["linear_iterations"]
    max_it = cfg["max_nonlinear_iterations"]

    # one assemble, one CPR update, one GMRES iteration on the final
    # ministep's system (its first Newton: state = state0 = its start)
    comp = sim.compiled
    full0 = merge_state(res.final_ministep_start_state, sim.parameters)
    dt = res.final_ministep_dt
    last = schedule[-1]
    assemble_ms = cuda_ms(lambda: comp.assemble(full0, full0, dt, last),
                          reps=5)
    r, J, _ = comp.assemble(full0, full0, dt, last)
    update_ms = cuda_ms(lambda: cpr.update(J), reps=5)
    pstate = cpr.update(J)
    n = r.shape[0]
    b = (-r).reshape(-1).contiguous()

    def matvec(v):
        return J.matvec(v.reshape(n, -1)).reshape(-1)

    def precond(v):
        return cpr.apply(pstate, J, v.reshape(n, -1)).reshape(-1)

    gm_its = 20  # one full GMRES(20) cycle at rtol 0
    gmres_iter_ms = cuda_ms(lambda: gmres(matvec, b, restart=20,
                                          maxiter=gm_its, rtol=0.0,
                                          precond=precond), reps=2) / gm_its
    del r, J, pstate
    torch.cuda.empty_cache()
    out = {
        "slice": "generic", "engine": "generic block-ELL (use_stencil=False)",
        "solver": "GenericKrylov(gmres, CPRPreconditioner(), rtol=1e-3, "
                  "max_iterations=50, restart=20)",
        "cells": nc, "path": "eager (simulate, fixed rtol)",
        "dtype": "float32", "report_steps": n_step,
        "ministeps": stats["ministeps"], "newtons": newtons,
        "failed_ministeps": stats["failed_ministeps"],
        "linear_iterations": lin, "wall_s": wall,
        "s_per_newton": wall / newtons,
        "cell_newton_its_per_s": nc * newtons / wall,
        "newtons_in_capped_ministeps": sum(
            m["iterations"] for r_ in res.reports for m in r_["ministeps"]
            if m["iterations"] >= max_it),
        "peak_mem_bytes": peak, "launches": launches,
        "setup_tables_s": tables_s, "setup_amg_hierarchy_s": amg_s,
        "fine_aggregation_s": {"native": agg_native_s, "loop": agg_loop_s},
        "amg_levels": [[lv.structure.n_rows, lv.structure.n_slots]
                       for lv in hier.levels],
        "assemble_ms": assemble_ms, "cpr_update_ms": update_ms,
        "gmres_iteration_ms": gmres_iter_ms,
        "per_ministep": [[m["iterations"], m["linear_iterations"]]
                         for r_ in res.reports for m in r_["ministeps"]],
    }
    log("# generic slice: " + json.dumps(out))
    return sim, res, last, out


def phase_generic_engine_check(case):
    """At full size in float64 on the card: one state assembled by both
    engines. The generic residual within 1e-10 of the stencil engine's
    (lattice K3), relative to the latter's max; the generic J v for a
    seeded v within 1e-10 of the stencil J v (K1). Then the generic
    ``assemble`` and the CPR ``update`` (and one ``apply``) twice on the
    same input: equal bits."""
    from jutul.jl_tpu_torch import CPRPreconditioner, compile_model
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import (StencilMatvec, launch_counts,
                                             reset_launch_counts)
    from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel

    model, state0, params, forces = case
    f64 = torch.float64
    st, pr = _flagship_state(model, state0, params, f64)
    full = merge_state(st, pr)
    full0 = merge_state(_flagship_state(model, state0, params, f64)[0], pr)
    full0["Pressure"] = full0["Pressure"] * (1.0 - 1e-4)
    comp = compile_model(model)
    stencil = StencilCompiledModel(comp)
    reset_launch_counts()
    rs, As, _ = stencil.assemble(full, full0, DT, forces)
    v = torch.randn(rs.shape, generator=torch.Generator(
        device="cuda").manual_seed(11), device="cuda", dtype=f64)
    ys = StencilMatvec(As)(v)
    launches = launch_counts()
    del As
    torch.cuda.empty_cache()
    rg, Jg, _ = comp.assemble(full, full0, DT, forces)
    yg = Jg.matvec(v)
    out = {"cells": rs.shape[0], "dtype": "float64",
           "residual_rel": rel_err(rg, rs), "jv_rel": rel_err(yg, ys),
           "launches": launches}
    if launches["darcy_flux_jacobian_lattice"] != 1 or \
            launches["stencil_matvec"] != 1:
        raise RuntimeError(f"engine check: the stencil side did not run "
                           f"K3 and K1 once each: {launches}")
    rg2, Jg2, _ = comp.assemble(full, full0, DT, forces)
    out["assemble_bitwise"] = bool(torch.equal(rg, rg2)
                                   and torch.equal(Jg.blocks, Jg2.blocks))
    del rg2, Jg2
    cpr = CPRPreconditioner()
    s1 = cpr.update(Jg)
    s2 = cpr.update(Jg)
    leaves = lambda s: [t for t in torch.utils._pytree.tree_leaves(s)  # noqa: E731
                        if torch.is_tensor(t)]
    out["cpr_update_bitwise"] = all(torch.equal(a, b) for a, b in
                                    zip(leaves(s1), leaves(s2)))
    out["cpr_apply_bitwise"] = bool(torch.equal(cpr.apply(s1, Jg, v),
                                                cpr.apply(s2, Jg, v)))
    log(f"# generic-engine-check ({out['cells']:,} cells, f64, card): "
        + json.dumps(out))
    if not (out["residual_rel"] <= 1e-10 and out["jv_rel"] <= 1e-10):
        raise RuntimeError(f"engine check: engines differ: {out}")
    if not (out["assemble_bitwise"] and out["cpr_update_bitwise"]
            and out["cpr_apply_bitwise"]):
        raise RuntimeError(f"engine check: a repeat differs: {out}")
    del s1, s2, Jg, rg, rs
    torch.cuda.empty_cache()
    return out


def phase_generic_fused(sim, case, amg, rtol=1e-3):
    """One Newton's linear system of the generic slice — its first: the
    initial state over the first ministep (1.5 h, the selector's initial
    fraction of a 6 h step) under the first step's rates — solved by
    ``GenericKrylov("bicgstab", CPRPreconditioner(), use_fused_body=True)``
    (K6/K7 on the flat vectors) and by the plain chain, both sharing the
    slice's AMG hierarchy. Both must converge (their recurrences reach
    rtol). A float32 recurrence drifts from the true residual (on this
    system at 16x16x8 on a CPU: 5.2e-4 against a true 2.2e-3, the same
    for both bodies), so the true residuals, evaluated in float64, are
    held to 10 rtol and the solutions' gap to their sum, |J dx| <= 20 rtol
    |b|; K6 and K7 launch once per fused iteration, no stencil kernel
    ever."""
    from jutul.jl_tpu_torch import (BlockELL, CPRPreconditioner,
                                    GenericKrylov, from_numpy)
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, _, forces = case
    full0 = merge_state(from_numpy(state0, sim.device, sim.dtype),
                        sim.parameters)
    r, J, _ = sim.compiled.assemble(full0, full0, 0.25 * DT,
                                    rate_schedule(forces, 3)[0])
    J64 = BlockELL(J.structure, J.blocks.double())
    b = -r.double()
    bnorm = float(torch.linalg.vector_norm(b))
    out, sols = {}, {}
    for tag, fused in (("fused", True), ("plain", None)):
        solver = GenericKrylov("bicgstab", CPRPreconditioner(amg=amg),
                               rtol=rtol, max_iterations=50,
                               use_fused_body=fused)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        du, stats = solver.solve(J, r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        du = du.double()
        true_rel = float(torch.linalg.vector_norm(b - J64.matvec(du))) / bnorm
        sols[tag] = du
        out[tag] = {"iterations": stats["iterations"],
                    "converged": bool(stats["converged"]),
                    "recurrence_rel_residual": float(stats["residual"])
                    / bnorm, "true_rel_residual": true_rel,
                    "solve_s": wall, "launches": launches}
        if not out[tag]["converged"] or true_rel > 10 * rtol:
            raise RuntimeError(f"generic-fused {tag}: not converged: {out}")
    its = out["fused"]["iterations"]
    lf = out["fused"]["launches"]
    _check_launches("generic-fused", "generic-fused", lf)
    if not lf["fused_alpha_s"] == its == lf["fused_omega_update"]:
        raise RuntimeError(f"generic-fused: K6/K7 launches {lf} differ from "
                           f"its {its} iterations")
    if any(out["plain"]["launches"].values()):
        raise RuntimeError(f"generic-fused: the plain chain launched "
                           f"{out['plain']['launches']}")
    out["solution_rel_residual_gap"] = float(torch.linalg.vector_norm(
        J64.matvec(sols["fused"] - sols["plain"]))) / bnorm
    out["launches"] = lf
    log("# generic-fused: " + json.dumps(out))
    if out["solution_rel_residual_gap"] > 20 * rtol:
        raise RuntimeError(f"generic-fused: solutions differ: {out}")
    del r, J, J64, sols
    torch.cuda.empty_cache()
    return out


def phase_generic_cross_check(dims=WELL_SMALL_EW):
    """The generic slice at ``dims`` (source-term wells) in float64, 2
    report steps, on the card and on the CPU, through the eager path and
    the schedule path (``simulate_jit``, Eisenstat-Walker forcing):
    identical ministep, Newton and linear-iteration counts, states within
    1e-9."""
    from jutul.jl_tpu_torch import Simulator

    model, state0, params, forces = build_flagship(*dims)
    out = {}
    for product in (False, True):
        runs = {}
        for dev in ("cuda", "cpu"):
            sim = Simulator(model, state0, params, use_stencil=False,
                            device=dev, dtype=torch.float64)
            run = sim.simulate_jit if product else sim.simulate
            res = run([DT] * 2, forces=rate_schedule(forces, 2),
                      **generic_config(product=product))
            runs[dev] = (res, [(m["iterations"], m["linear_iterations"],
                                m["success"]) for r in res.reports
                               for m in r["ministeps"]])
        tag = "schedule" if product else "eager"
        if runs["cuda"][1] != runs["cpu"][1]:
            raise RuntimeError(f"generic cross-check ({tag}): counts differ: "
                               f"card {runs['cuda'][1]} CPU {runs['cpu'][1]}")
        dev_p = dev_s = 0.0
        for sg, sc in zip(runs["cuda"][0].states, runs["cpu"][0].states):
            dev_p = max(dev_p, float(np.max(np.abs(
                sg["Pressure"] / sc["Pressure"] - 1))))
            dev_s = max(dev_s, float(np.max(np.abs(
                sg["Saturations"] - sc["Saturations"]))))
        out[tag] = {"ministeps": len(runs["cpu"][1]),
                    "newtons": sum(m[0] for m in runs["cpu"][1]),
                    "linear_iterations": sum(m[1] for m in runs["cpu"][1]),
                    "max_rel_dev_pressure": dev_p,
                    "max_abs_dev_saturations": dev_s}
        if not (dev_p <= 1e-9 and dev_s <= 1e-9):
            raise RuntimeError(f"generic cross-check ({tag}): states "
                               f"differ: {out[tag]}")
    log(f"# generic cross-check card vs CPU ({'x'.join(map(str, dims))}, "
        f"f64): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# the MultiModel: the well flagship's 5 wells as coupled one-cell models
# ---------------------------------------------------------------------------
def phase_multimodel(case_mm, n_step=3):
    """``wells-multimodel``: the well MultiModel at full width in float32
    on the card through the schedule path as ``wells-product`` runs it
    (``lower_schedule`` with the rate ramp, EW forcing, 16 ministep
    records per report step, then ``post(*run(*args))``), with srcwells'
    Newton settings and ``multimodel_solver``. The host set-up (every
    submodel's ELL structure and sum plans, the reservoir's AMG hierarchy)
    is timed apart, before the run; no kernel may launch; every report
    step must succeed and the Newton loop read the device once per
    assembly. Returns (sim, res, last forces, record)."""
    from jutul.jl_tpu_torch import Simulator, report_stats
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    mm, state0, params, forces = case_mm
    nc = sum(m.number_of_cells() for m in mm.models.values())
    sim = Simulator(mm, state0, params)  # the card
    schedule = rate_schedule(forces, n_step)
    cfg = multimodel_config(product=True)
    cpr = cfg["linear_solver"].inner.preconditioner.preconditioners
    t0 = time.perf_counter()
    ells = {n: c.ell for n, c in sim.compiled.comps.items()}
    tables_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hier = cpr.amg._symbolic(ells["reservoir"])
    amg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # one output state per report step: dd-multimodel holds its state at
    # the end of the first against this run's
    run, args, post = sim.lower_schedule([DT] * n_step, forces=schedule,
                                         jit_output_states=True, **cfg)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = post(*run(*args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = report_stats(res.reports)
    if not all(r["success"] for r in res.reports) or \
            len(res.reports) != n_step:
        raise RuntimeError("wells-multimodel: a report step failed")
    for m, st in res.states[-1].items():
        for k, v in st.items():
            if not np.all(np.isfinite(v)):
                raise RuntimeError(f"wells-multimodel: final {m}.{k} not "
                                   "finite")
    _check_launches("wells-multimodel", "wells-multimodel", launches)
    newtons, lin = stats["newtons"], stats["linear_iterations"]
    if sim.host_reads != newtons + stats["ministeps"]:
        raise RuntimeError(f"wells-multimodel: {sim.host_reads} Newton host "
                           f"reads for {newtons} solves in "
                           f"{stats['ministeps']} ministeps")
    max_it = cfg["max_nonlinear_iterations"]
    out = {
        "slice": "wells-multimodel",
        "engine": "MultiModel (reservoir + 5 one-cell well models, "
                  "DarcyTransferCrossTerm perforations; generic engine)",
        "solver": "SchurComplementSolver(GenericKrylov(gmres, "
                  "GroupWisePreconditioner(CPRPreconditioner()), rtol=1e-3, "
                  "max_iterations=50, restart=20), elim_models=wells)",
        "cells": nc, "path": "schedule (lower_schedule, EW forcing)",
        "dtype": "float32", "report_steps": n_step,
        "ministeps": stats["ministeps"], "newtons": newtons,
        "failed_ministeps": stats["failed_ministeps"],
        "linear_iterations": lin, "wall_s": wall,
        "s_per_newton": wall / newtons,
        "cell_newton_its_per_s": nc * newtons / wall,
        "host_reads": sim.host_reads,
        "host_reads_per_newton": sim.host_reads / newtons,
        "newtons_in_capped_ministeps": sum(
            m["iterations"] for r in res.reports for m in r["ministeps"]
            if m["iterations"] >= max_it),
        "peak_mem_bytes": peak, "launches": launches,
        "setup_tables_s": tables_s, "setup_amg_hierarchy_s": amg_s,
        "setup_lower_schedule_s": setup_s,
        "amg_levels": [[lv.structure.n_rows, lv.structure.n_slots]
                       for lv in hier.levels],
        "per_ministep": [[m["iterations"], m["linear_iterations"]]
                         for r in res.reports for m in r["ministeps"]],
    }
    log("# wells-multimodel: " + json.dumps(out))
    return sim, res, schedule[-1], out


def multimodel_engine_check(case_mm, case_graph, state, state0, dt,
                            forces_mm, forces_graph, device, seed=11):
    """One state through both well formulations in float64 on
    ``device``: the MultiModel's residual and J v (v seeded) against the
    generic engine's on the WellGraphMesh model, reservoir rows on
    reservoir rows and well model i's row on wellbore cell nc + i;
    relative to the graph's max. The two upwind rules differ only at an
    exact pressure tie across a perforation (the cross term takes the
    source side, the graph face the left, reservoir side): where one
    exists, every pressure of the state is perturbed by a seeded relative
    1e-9 and ``perturbed_for_ties`` counts the ties."""
    from jutul.jl_tpu_torch import compile_model, from_numpy
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.multimodel.core import compile_multi_model

    f64 = torch.float64
    mm, _, params_mm, _ = case_mm
    gmodel, _, params_g, _ = case_graph
    st = from_numpy(state, device, f64)
    st0 = from_numpy(state0, device, f64)
    ties = sum(int((st["reservoir"]["Pressure"][torch.as_tensor(
        p.target_cells, device=st["reservoir"]["Pressure"].device)]
        == st[p.source]["Pressure"][0]).sum()) for p in mm.cross_terms)
    if ties:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        st = {m: {**s, "Pressure": s["Pressure"] * (1 + 1e-9 * torch.randn(
            s["Pressure"].shape, generator=gen, device=device, dtype=f64))}
            for m, s in st.items()}
    order = ("reservoir",) + WELL_NAMES

    def graph(d):
        return {k: torch.cat([d[m][k] for m in order]) for k in d[order[0]]}

    pr_mm = from_numpy(params_mm, device, f64)
    pr_g = from_numpy(params_g, device, f64)
    cm = compile_multi_model(mm)
    r_m, J_m, _ = cm.assemble(
        {m: merge_state(st[m], pr_mm[m]) for m in order},
        {m: merge_state(st0[m], pr_mm[m]) for m in order}, dt, forces_mm)
    r_g, J_g, _ = compile_model(gmodel).assemble(
        merge_state(graph(st), pr_g), merge_state(graph(st0), pr_g), dt,
        forces_graph)
    v = torch.randn(r_g.shape, generator=torch.Generator(
        device=device).manual_seed(seed), device=device, dtype=f64)
    nc = st["reservoir"]["Pressure"].shape[0]
    v_mm = {"reservoir": v[:nc], **{w: v[nc + i:nc + i + 1]
                                    for i, w in enumerate(WELL_NAMES)}}
    y_m = J_m.matvec(v_mm)
    y_g = J_g.matvec(v)
    return {"rows": r_g.shape[0], "dtype": "float64",
            "perturbed_for_ties": ties,
            "residual_rel": rel_err(torch.cat([r_m[m] for m in order]), r_g),
            "jv_rel": rel_err(torch.cat([y_m[m] for m in order]), y_g)}


def phase_multimodel_engine_check(case_mm, case_graph, res, n_step=3):
    """``multimodel-engine-check``: wells-multimodel's last accepted
    ministep (its end and start states, cast to float64, its dt and the
    last step's forces) through ``multimodel_engine_check`` at full size
    on the card: both deviations within 1e-12."""
    forces_g = rate_schedule(case_graph[3], n_step)[-1]
    forces_mm = rate_schedule(case_mm[3], n_step)[-1]
    out = multimodel_engine_check(
        case_mm, case_graph, res.final_state_device,
        res.final_ministep_start_state, res.final_ministep_dt, forces_mm,
        forces_g, "cuda")
    log(f"# multimodel-engine-check ({out['rows']:,} rows, f64, card): "
        + json.dumps(out))
    if not (out["residual_rel"] <= 1e-12 and out["jv_rel"] <= 1e-12):
        raise RuntimeError(f"multimodel engine check: the formulations "
                           f"differ: {out}")
    torch.cuda.empty_cache()
    return out


def phase_multimodel_fused(sim, case_mm, rtol=1e-3):
    """``multimodel-fused``: the first Newton system of wells-multimodel
    (the initial state over the first ministep, a quarter of the first
    6 h step, under the first step's rates), Schur-reduced onto the
    reservoir and solved by ``GenericKrylov("bicgstab",
    GroupWisePreconditioner(CPRPreconditioner()), use_fused_body=True)``:
    K6/K7 launch once per iteration on the flat coupled vector, no stencil
    kernel ever; the true residual of the whole coupled system (float64) within
    10 rtol."""
    from jutul.jl_tpu_torch import (CPRPreconditioner, GenericKrylov,
                                    GroupWisePreconditioner,
                                    SchurComplementSolver, from_numpy)
    from jutul.jl_tpu_torch.multimodel.core import (CouplingBlock,
                                                    MultiLinearizedSystem)
    from jutul.jl_tpu_torch.ops.blockell import BlockELL
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    mm, state0, _, forces = case_mm
    st = from_numpy(state0, sim.device, sim.dtype)
    full0 = sim._merge(st, sim.parameters)
    r, J, _ = sim.compiled.assemble(full0, full0, 0.25 * DT,
                                    rate_schedule(forces, 3)[0])
    solver = SchurComplementSolver(
        inner=GenericKrylov("bicgstab",
                            GroupWisePreconditioner(CPRPreconditioner()),
                            rtol=rtol, max_iterations=50,
                            use_fused_body=True),
        elim_models=list(WELL_NAMES))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    du, stats = solver.solve(J, r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    J64 = MultiLinearizedSystem(
        {n: BlockELL(d.structure, d.blocks.double())
         for n, d in J.diag.items()},
        [CouplingBlock(c.target, c.source, c.rows, c.cols, c.blocks.double())
         for c in J.couplings], J.layout)
    b = {n: -v.double() for n, v in r.items()}
    res_true = J64.matvec({n: v.double() for n, v in du.items()})
    bnorm = float(torch.linalg.vector_norm(J64.flatten_res(b)))
    true_rel = float(torch.linalg.vector_norm(
        J64.flatten_res(b) - J64.flatten_res(res_true))) / bnorm
    its = stats["iterations"]
    out = {"iterations": its, "converged": bool(stats["converged"]),
           "true_rel_residual": true_rel, "solve_s": wall,
           "launches": launches}
    log("# multimodel-fused: " + json.dumps(out))
    _check_launches("multimodel-fused", "multimodel-fused", launches)
    if not launches["fused_alpha_s"] == its == \
            launches["fused_omega_update"]:
        raise RuntimeError(f"multimodel-fused: K6/K7 launches {launches} "
                           f"differ from its {its} iterations")
    if not out["converged"] or true_rel > 10 * rtol:
        raise RuntimeError(f"multimodel-fused: not converged: {out}")
    del r, J, J64, du
    torch.cuda.empty_cache()
    return out


def _mm_state_devs(a, b):
    """(max relative Pressure deviation, max absolute Saturations
    deviation) over every submodel of two MultiModel states."""
    dp = max(float(np.max(np.abs(a[m]["Pressure"] / b[m]["Pressure"] - 1)))
             for m in b)
    ds = max(float(np.max(np.abs(a[m]["Saturations"]
                                 - b[m]["Saturations"]))) for m in b)
    return dp, ds


def phase_multimodel_cross_check(dims=WELL_SMALL_EW):
    """``multimodel-cross-check``: the well MultiModel at ``dims`` in
    float64, 2 report steps with the rate ramp, on the card and on the
    CPU, through the eager path and the schedule path (EW forcing):
    identical ministep, Newton and linear-iteration counts, states within
    1e-12; the schedule path twice on the card, equal bit for bit. Then
    ``solve_adjoint_sensitivities`` on the MultiModel (dense λ-solves) on
    the card and on the CPU, on the same states (one tight float64 CPU
    forward of 2 steps of 1.5 h, one ministep each) and the same G: each
    parameter's gradient over the coupled system (every submodel's
    entries together, as the well-graph model's one vector holds its
    wellbore cells) within 1e-10 of the CPU's, relative to its largest
    entry."""
    from jutul.jl_tpu_torch import (DirectSolver, Simulator, report_stats,
                                    solve_adjoint_sensitivities)

    mm, state0, params, forces = build_well_multimodel(*dims)
    sched = rate_schedule(forces, 2)
    out = {}
    for product in (False, True):
        runs = []
        for dev in ("cuda", "cuda", "cpu") if product else ("cuda", "cpu"):
            sim = Simulator(mm, state0, params, device=dev,
                            dtype=torch.float64)
            run = sim.simulate_jit if product else sim.simulate
            res = run([DT] * 2, forces=sched,
                      **multimodel_config(product=product))
            runs.append((res, [(m["iterations"], m["linear_iterations"],
                                m["success"]) for r in res.reports
                               for m in r["ministeps"]]))
        tag = "schedule" if product else "eager"
        if any(c != runs[-1][1] for _, c in runs):
            raise RuntimeError(f"multimodel cross-check ({tag}): counts "
                               f"differ: {[c for _, c in runs]}")
        devs = [_mm_state_devs(a, b)
                for a, b in zip(runs[0][0].states, runs[-1][0].states)]
        out[tag] = {"ministeps": len(runs[-1][1]),
                    "newtons": sum(c[0] for c in runs[-1][1]),
                    "linear_iterations": sum(c[1] for c in runs[-1][1]),
                    "max_rel_dev_pressure": max(d[0] for d in devs),
                    "max_abs_dev_saturations": max(d[1] for d in devs)}
        if product:
            out[tag]["card_runs_bitwise"] = all(
                np.array_equal(a[m][k], b[m][k])
                for a, b in zip(runs[0][0].states, runs[1][0].states)
                for m in a for k in a[m])
    log(f"# multimodel cross-check card vs CPU ({'x'.join(map(str, dims))}"
        f", f64): " + json.dumps(out))
    for tag, o in out.items():
        if not o.get("card_runs_bitwise", True):
            raise RuntimeError(f"multimodel cross-check ({tag}): two card "
                               f"runs differ: {o}")
        if not (o["max_rel_dev_pressure"] <= 1e-12
                and o["max_abs_dev_saturations"] <= 1e-12):
            raise RuntimeError(f"multimodel cross-check ({tag}): states "
                               f"differ: {o}")
    dts = [ADJ_DT] * 2
    fwd = Simulator(mm, state0, params, device="cpu",
                    dtype=torch.float64).simulate(
        dts, forces=sched, linear_solver=DirectSolver(), info_level=-1,
        tolerances={"default": 1e-10}, max_nonlinear_iterations=40)
    if report_stats(fwd.reports)["ministeps"] != len(dts):
        raise RuntimeError("multimodel cross-check: the adjoint's forward "
                           "took more than one ministep per step")
    nc = mm["reservoir"].number_of_cells()

    def G(mm_, state, dt, n, f):
        return dt * torch.sum(
            state["reservoir"]["Saturations"][:, 0] ** 2) / nc

    grads = {dev: solve_adjoint_sensitivities(
        mm, fwd.states, dts, G, parameters=params, state0=state0,
        forces=sched, device=dev, dtype=torch.float64)
        for dev in ("cuda", "cpu")}
    def family(dev, k):  # one parameter over every submodel, flattened
        return np.concatenate([np.ravel(g[k]) for g in grads[dev].values()
                               if k in g])

    keys = sorted({k for g in grads["cpu"].values() for k in g})
    adj = {k: float(np.abs(family("cuda", k) - family("cpu", k)).max()
                    / np.abs(family("cpu", k)).max())
           for k in keys if np.any(family("cpu", k))}
    # each submodel's entries against their own largest, for the record
    by_model = {f"{m}.{k}": float(np.abs(grads["cuda"][m][k] - g[k]).max()
                                  / np.abs(g[k]).max())
                for m, g in grads["cpu"].items() for k in g if np.any(g[k])}
    out["adjoint_rel_dev"] = max(adj.values())
    out["adjoint_rel_dev_by_parameter"] = adj
    out["adjoint_rel_dev_by_model"] = by_model
    log("# multimodel adjoint card vs CPU (dense λ, f64): "
        + json.dumps({"by_parameter": adj, "by_model": by_model}))
    if not out["adjoint_rel_dev"] <= 1e-10:
        raise RuntimeError(f"multimodel cross-check: adjoint gradients "
                           f"differ: {adj}")
    return out


ADJ_DT = 1.5 * 3600.0  # bench.py run_adjoint's report step (BENCH_ADJ_DT)
# kernels the adjoint's sweep must never launch: the opt-in smoothers and
# Krylov bodies, and every bfloat16 entry
ADJOINT_FORBIDDEN = ("scalar_jacobi", "scalar_chebyshev", K9, K11,
                     "fused_alpha_s", "fused_omega_update") + tuple(
    k for k in KERNEL_INFO if k.endswith("_bf16c"))


def adjoint_solvers(fwd_rtol=1e-3, fwd_its=50, lam_rtol=1e-6, lam_its=100):
    """bench.py run_adjoint's solvers (bench.py:814-817, 863-870): the
    forward's and the λ-solves' CPR(GMG(2, 12, 16384))-BiCGStab."""
    from jutul.jl_tpu_torch import GMG, StencilCPR, StencilKrylovSolver

    def solver(rtol, its):
        return StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=GMG(
                n_smooth=2, n_coarse_sweeps=12, min_cells=16384)),
            rtol=rtol, max_iterations=its)

    return solver(fwd_rtol, fwd_its), solver(lam_rtol, lam_its)


def adjoint_forward_config(solver):
    """bench.py run_adjoint's forward settings (bench.py:822-833)."""
    return dict(linear_solver=solver,
                tolerances={"mass_conservation/CNV": CNV_TOL,
                            "mass_conservation/MB": MB_TOL},
                max_nonlinear_iterations=15, tol_factor_final_iteration=10.0,
                jit_report_capacity=16, linear_forcing="ew",
                output_variables="primary", jit_output_states=True,
                info_level=-1)


def sat_objective(nc):
    """bench.py run_adjoint's G = dt Σ S_w² / nc (bench.py:858-859), over
    every row (lattice and wellbore cells), nc the lattice's cells."""
    def G(model, state, dt, n, forces):
        return dt * torch.sum(state["Saturations"][:, 0] ** 2) / nc
    return G


def _record_solves(storage):
    """Wrap ``storage.solve_transposed`` to record each λ-solve's kernel
    launches (the launch counts' change across the call)."""
    from jutul.jl_tpu_torch.ops.cuda import launch_counts

    per_solve = []
    inner = storage.solve_transposed

    def solve(blocks, rhs):
        before = launch_counts()
        lam = inner(blocks, rhs)
        after = launch_counts()
        per_solve.append({k: after[k] - before[k] for k in after})
        return lam

    storage.solve_transposed = solve
    return per_solve


def check_adjoint_launches(launches, per_solve, n_step):
    """K1, K10 (the fine and mid GMG levels) and K8 (the coarse solve) in
    every λ-solve and nowhere else; the three-axis and the per-axis K3 once
    per step (that step's Jacobian: the differentiable residual launches
    nothing); no K2 pass, no opt-in kernel, no bfloat16 entry."""
    for k in ("stencil_matvec", K10, K8):
        if any(s[k] <= 0 for s in per_solve):
            raise RuntimeError(f"wells-adjoint: {k} missing from a λ-solve: "
                               f"{per_solve}")
        if sum(s[k] for s in per_solve) != launches[k]:
            raise RuntimeError(f"wells-adjoint: {k} launched outside the "
                               f"λ-solves: {launches}")
    for k in ("darcy_flux_jacobian", "darcy_flux_jacobian_lattice"):
        if launches[k] != n_step:
            raise RuntimeError(f"wells-adjoint: {k} launched {launches[k]} "
                               f"times in {n_step} steps")
    stray = [k for k in ADJOINT_FORBIDDEN if launches[k]]
    if stray:
        raise RuntimeError(f"wells-adjoint: {stray} launched: {launches}")


def phase_adjoint(case, n_step=2, device="cuda"):
    """bench.py run_adjoint at full width: the schedule-path forward
    (``lower_schedule`` then ``post(*run(*args))``) over ``n_step`` report
    steps of 1.5 h, then ``solve_adjoint_sensitivities_jit`` of G over its
    output states, once cold and once warm, with the λ-solves at rtol 1e-6.
    The states must be the accepted ministep sequence (one ministep per
    report step), the gradient finite; ``check_adjoint_launches`` holds the
    warm sweep's launches. ``overhead`` = sweep / forward run (bench.py's
    device-side ratio), ``overhead_vs_forward_wall`` with the states'
    copy to the host included."""
    from jutul.jl_tpu_torch import (
        AdjointStorage,
        Simulator,
        report_stats,
        solve_adjoint_sensitivities_jit,
    )
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, params, forces = case
    nc = model.domain.mesh._nc_base
    fwd, lam = adjoint_solvers()
    sim = Simulator(model, state0, params, use_stencil=True, device=device)
    dts = [ADJ_DT] * n_step
    run, args, post = sim.lower_schedule(dts, forces=forces,
                                         **adjoint_forward_config(fwd))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(*args)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    res = post(*out)
    t_forward = time.perf_counter() - t0
    fwd_launches = launch_counts()
    stats = report_stats(res.reports)
    if stats["ministeps"] != n_step or not all(r["success"]
                                               for r in res.reports):
        raise RuntimeError(f"wells-adjoint: the forward took "
                           f"{stats['ministeps']} ministeps in {n_step} "
                           "report steps: its states are not the accepted "
                           "ministep sequence the adjoint transposes")
    G = sat_objective(nc)
    storage = AdjointStorage(model, params, linear_solver=lam,
                             use_stencil=True, device=device)
    per_solve = _record_solves(storage)

    def sweep():
        t0 = time.perf_counter()
        g = solve_adjoint_sensitivities_jit(
            model, res.states, dts, G, parameters=params, state0=state0,
            forces=forces, storage=storage)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, g

    t_cold, _ = sweep()
    per_solve.clear()
    storage.lambda_iterations.clear()
    storage.lambda_converged.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_sweep, g = sweep()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gt = g["Transmissibilities"]
    if not all(np.all(np.isfinite(v)) for v in g.values()):
        raise RuntimeError("wells-adjoint: non-finite gradient")
    check_adjoint_launches(launches, per_solve, n_step)
    its = list(storage.lambda_iterations)
    out = {
        "slice": "wells-adjoint", "cells": model.number_of_cells(),
        "dtype": "float32", "report_steps": n_step, "dt_s": ADJ_DT,
        "ministeps": stats["ministeps"], "newtons": stats["newtons"],
        "linear_iterations": stats["linear_iterations"],
        "adjoint_states_exact": True,
        "forward_run_s": t_run, "forward_wall_s": t_forward,
        "sweep_cold_s": t_cold, "sweep_s": t_sweep,
        "overhead": t_sweep / t_run,
        "overhead_vs_forward_wall": t_sweep / t_forward,
        "lambda_iterations_per_step": its[::-1],  # step order
        "lambda_converged_per_step": storage.lambda_converged[::-1],
        "lambda_rtol": lam.rtol,
        "lambda_max_iterations": lam.max_iterations,
        "grad_trans_max_abs": float(
            np.abs(gt).max()),
        "peak_mem_bytes": peak, "launches": launches,
        "forward_launches": fwd_launches,
        "launches_per_lambda_iteration": {
            k: launches[k] / max(sum(its), 1) for k in (
                "stencil_matvec", K10, K8, "darcy_flux_jacobian",
                "darcy_flux_jacobian_lattice")},
        "launches_per_lambda_solve": per_solve,
    }
    log("# wells-adjoint: " + json.dumps(out))
    return out, g, res.states


def _fd_forward(case, params, dts, device, dtype=torch.float64):
    """The dot test's tight forward (bench.py:742-767): float64,
    CNV 1e-8 / MB 1e-10, rtol 1e-10 over at most 300 iterations, 40
    Newtons; one ministep per report step or it raises."""
    from jutul.jl_tpu_torch import Simulator, report_stats

    model, state0, _, forces = case
    solver, _ = adjoint_solvers(fwd_rtol=1e-10, fwd_its=300)
    res = Simulator(model, state0, params, use_stencil=True, device=device,
                    dtype=dtype).simulate(
        dts, forces=forces, linear_solver=solver, info_level=-1,
        tolerances={"mass_conservation/CNV": 1e-8,
                    "mass_conservation/MB": 1e-10},
        max_nonlinear_iterations=40)
    st = report_stats(res.reports)
    if not all(r["success"] for r in res.reports) or \
            st["ministeps"] != len(dts):
        raise RuntimeError(f"adjoint-dot: the f64 forward took "
                           f"{st['ministeps']} ministeps in {len(dts)} "
                           "steps")
    return res.states


def _G_np(states, dts, nc):
    return sum(dts[i] * float(np.sum(np.asarray(s["Saturations"],
                                                np.float64)[:, 0] ** 2)) / nc
               for i, s in enumerate(states))


def phase_adjoint_dot(case, n_step=2, hs=(1e-3, 1e-4), device="cuda"):
    """bench.py's dot test (``_adjoint_dot_test_f64``, bench.py:718-779) on
    the card: <∇G, δ> against the central difference (G(p + hδ) −
    G(p − hδ)) / 2h of float64 forwards, δ = T0 ∘ N(0, 1) (seed 7), at
    bench's h = 1e-3 and at 1e-4. The float64 adjoint (λ-solves at rtol
    1e-10) must agree to 1e-3 with the difference at the smallest h: at
    1e-3 the difference's own truncation error (a curved objective) is of
    the order of the bar at this size, and it falls with h against the
    same converged adjoint. The float32 sweep (bench's forward and
    λ-solves) is reported, each with its λ-solves' iterations."""
    from jutul.jl_tpu_torch import (
        AdjointStorage,
        Simulator,
        report_stats,
        solve_adjoint_sensitivities_jit,
    )

    model, state0, params, forces = case
    nc = model.domain.mesh._nc_base
    dts = [ADJ_DT] * n_step
    G = sat_objective(nc)
    T0 = np.asarray(params["Transmissibilities"], np.float64)
    delta = T0 * np.random.default_rng(7).normal(size=T0.shape)
    t0 = time.perf_counter()
    fds = []
    for h in hs:
        g_pm = [_G_np(_fd_forward(case, dict(
            params, Transmissibilities=T0 + sign * h * delta), dts, device),
            dts, nc) for sign in (1.0, -1.0)]
        fds.append((g_pm[0] - g_pm[1]) / (2.0 * h))
    _, lam64 = adjoint_solvers(lam_rtol=1e-10, lam_its=1000)
    states64 = _fd_forward(case, params, dts, device)
    st64 = AdjointStorage(model, params, linear_solver=lam64,
                          use_stencil=True, device=device,
                          dtype=torch.float64)
    g64 = solve_adjoint_sensitivities_jit(
        model, states64, dts, G, parameters=params, state0=state0,
        forces=forces, storage=st64)["Transmissibilities"]
    fwd, lam = adjoint_solvers()
    res32 = Simulator(model, state0, params, use_stencil=True,
                      device=device, dtype=torch.float32).simulate_jit(
        dts, forces=forces, **adjoint_forward_config(fwd))
    st32 = AdjointStorage(model, params, linear_solver=lam,
                          use_stencil=True, device=device,
                          dtype=torch.float32)
    g32 = solve_adjoint_sensitivities_jit(
        model, res32.states, dts, G, parameters=params, state0=state0,
        forces=forces, storage=st32)["Transmissibilities"]
    torch.cuda.synchronize()
    gd64, gd32 = float(np.sum(g64 * delta)), float(np.sum(g32 * delta))
    fd = fds[-1]
    out = {"cells": model.number_of_cells(), "h": list(hs), "fd": fds,
           "dot_f64": gd64, "rel_err_f64_by_h": [
               abs(f - gd64) / abs(gd64) for f in fds],
           "rel_err_f64": abs(fd - gd64) / abs(gd64),
           "lambda_iterations_f64": st64.lambda_iterations,
           "lambda_converged_f64": st64.lambda_converged,
           "dot_f32_sweep": gd32, "rel_err_f32_sweep": abs(fd - gd32) / abs(
               gd32), "f32_forward_ministeps": report_stats(
               res32.reports)["ministeps"],
           "lambda_iterations_f32": st32.lambda_iterations,
           "lambda_converged_f32": st32.lambda_converged,
           "seconds": time.perf_counter() - t0}
    log("# adjoint-dot (f64 card FD): " + json.dumps(out))
    if not out["rel_err_f64"] <= 1e-3:
        raise RuntimeError(f"adjoint-dot: f64 gradient off by "
                           f"{out['rel_err_f64']:.3e} > 1e-3 at h = "
                           f"{hs[-1]}")
    return out, dict(zip(hs, fds)), states64


def phase_history_match(case, n_step=2, max_iterations=3, device="cuda"):
    """The optimizer harness around the adjoint: observations are the
    Saturations of a forward run at the true parameters; the case starts
    at Transmissibilities x 0.5; G = l2_misfit_objective; unit-box L-BFGS
    (log-scaled transmissibilities) over ``setup_parameter_optimization``'s
    F_and_dF with wells-adjoint's solvers (the eager forward at bench's
    tolerances). Every value and gradient must be finite and the objective
    after ``max_iterations`` strictly below the start."""
    from jutul.jl_tpu_torch import (
        JutulCase,
        setup_parameter_optimization,
        simulate,
        unit_box_bfgs,
    )
    from jutul.jl_tpu_torch.adjoint.objectives import l2_misfit_objective

    model, state0, params, forces = case
    dts = [ADJ_DT] * n_step
    fwd, lam = adjoint_solvers()
    kw = adjoint_forward_config(fwd)
    for k in ("jit_report_capacity", "linear_forcing", "jit_output_states",
              "info_level"):
        kw.pop(k)  # schedule-path options: the harness runs simulate
    kw.update(device=device, dtype=torch.float32, use_stencil=True)
    obs = [s["Saturations"] for s in simulate(
        state0, model, dts, forces=forces, parameters=params,
        info_level=-1, **kw).states]
    start = dict(params, Transmissibilities=0.5 * np.asarray(
        params["Transmissibilities"]))
    opt = setup_parameter_optimization(
        JutulCase(model, dts, forces, state0=state0, parameters=start),
        l2_misfit_objective({"Saturations": obs}),
        targets=["Transmissibilities"], adjoint_linear_solver=lam, **kw)
    evals = []
    t0 = time.perf_counter()

    def f_and_g(x):
        t1 = time.perf_counter()
        v, g = opt.F_and_dF(x)
        if not (np.isfinite(v) and np.all(np.isfinite(g))):
            raise RuntimeError("history-match: non-finite value or gradient")
        evals.append({"value": v, "grad_norm": float(np.linalg.norm(g)),
                      "wall_s": time.perf_counter() - t1})
        return v, g

    v, _, hist = unit_box_bfgs(opt.x0(), f_and_g,
                               max_iterations=max_iterations)
    torch.cuda.synchronize()
    out = {"cells": model.number_of_cells(), "parameters": opt.n,
           "values": hist.values, "projected_grad_norms": hist.grad_norms,
           "steps": hist.steps, "evaluations": evals,
           "forward_runs": opt.evaluations,
           "wall_s": time.perf_counter() - t0}
    log("# history-match: " + json.dumps(out))
    if not (len(hist.values) > 1 and hist.values[-1] < hist.values[0]):
        raise RuntimeError(f"history-match: objective not lowered: "
                           f"{hist.values}")
    return out


def phase_adjoint_cross_check(dims, lam_rtol=1e-14):
    """The adjoint at ``dims`` in float64 on the card (kernels) and on the
    CPU (plain versions), on the same numpy states (one float64 CPU
    forward, tight, with the rate ramp) and the same G: gradients within
    1e-9 relative. The λ-solves run at ``lam_rtol``: at 1e-12 the
    transmissibility gradient of this case stops further from its converged
    value than the bar, in either package, so roundoff in the stopping test
    could fail the check without a fault."""
    from jutul.jl_tpu_torch import solve_adjoint_sensitivities_jit

    case = build_well_flagship(*dims)
    model, state0, params, forces = case
    sched = rate_schedule(forces, 2)
    dts = [ADJ_DT] * 2
    states = _fd_forward((model, state0, params, sched), params, dts, "cpu")
    _, lam = adjoint_solvers(lam_rtol=lam_rtol, lam_its=1000)
    G = sat_objective(model.domain.mesh._nc_base)
    grads = {dev: solve_adjoint_sensitivities_jit(
        model, states, dts, G, parameters=params, state0=state0,
        forces=sched, linear_solver=lam, include_state0=True,
        use_stencil=True, device=dev, dtype=torch.float64)
        for dev in ("cuda", "cpu")}
    out = {k: float(np.abs(grads["cuda"][k] - grads["cpu"][k]).max()
                    / np.abs(grads["cpu"][k]).max())
           for k in ("Transmissibilities", "FluidVolume", "state0")}
    log(f"# adjoint cross-check card vs CPU ({'x'.join(map(str, dims))}, "
        "f64): " + json.dumps(out))
    if not all(v <= 1e-9 for v in out.values()):
        raise RuntimeError(f"adjoint cross-check: gradients differ: {out}")
    return {**grads["cuda"], "states": states}


# ---------------------------------------------------------------------------
# the generic engine's adjoint, DictParameters, the setup-map and force
# gradients, and the eager loop's options
# ---------------------------------------------------------------------------
def generic_lambda_solver(rtol=1e-6, max_iterations=200):
    """bench.py run_adjoint's λ-solver under BENCH_ADJ_STENCIL=0
    (bench.py:872-879): ILU(0)-preconditioned BiCGStab on the transposed
    BlockELL."""
    from jutul.jl_tpu_torch import GenericKrylov, ILU0Preconditioner

    return GenericKrylov("bicgstab", ILU0Preconditioner(), rtol=rtol,
                         max_iterations=max_iterations)


def phase_generic_adjoint(case, states, g_stencil, forward_run_s, n_step=2,
                          device="cuda"):
    """bench.py run_adjoint with BENCH_ADJ_STENCIL=0 at full width: the
    forward is unchanged by that switch, so ``states`` are
    ``wells-adjoint``'s accepted states; the sweep is
    ``solve_adjoint_sensitivities_jit`` of bench's G on
    ``AdjointStorage(model, params, linear_solver=ILU(0)-BiCGStab at rtol
    1e-6, 200 iterations)`` — the generic engine's BlockELL Jacobian and
    λ-solves — in float32, once cold and twice warm. The gradient must be
    finite, the warm sweeps must launch no kernel of ops/cuda (the generic
    path has none) and give equal bits. Reported: the sweep's seconds and
    its overhead against ``wells-adjoint``'s forward run, the λ-solves'
    iterations, CUDA-event times of one Jacobian, one ILU(0) update and one
    BiCGStab iteration, the peak memory, the storage's host set-up (the ELL
    structure and its transpose table) and the Transmissibilities
    gradient's relative difference from ``wells-adjoint``'s stencil one
    (both λ-solves stop at loose float32 tolerances)."""
    from jutul.jl_tpu_torch import (
        AdjointStorage,
        BlockELL,
        solve_adjoint_sensitivities_jit,
    )
    from jutul.jl_tpu_torch.linsolve.krylov import bicgstab
    from jutul.jl_tpu_torch.ops.blockell import ell_transpose
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, params, forces = case
    nc = model.domain.mesh._nc_base
    dts = [ADJ_DT] * n_step
    G = sat_objective(nc)
    lam = generic_lambda_solver()
    t0 = time.perf_counter()
    storage = AdjointStorage(model, params, linear_solver=lam, device=device)
    storage_s = time.perf_counter() - t0

    def sweep():
        t0 = time.perf_counter()
        g = solve_adjoint_sensitivities_jit(
            model, states, dts, G, parameters=params, state0=state0,
            forces=forces, storage=storage)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, g

    t_cold, _ = sweep()
    storage.lambda_iterations.clear()
    storage.lambda_converged.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_sweep, g = sweep()
    _, g2 = sweep()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.all(np.isfinite(v)) for v in g.values()):
        raise RuntimeError("generic-adjoint: non-finite gradient")
    if any(launches.values()):
        raise RuntimeError(f"generic-adjoint: the warm sweeps launched "
                           f"kernels of ops/cuda: {launches}")
    unequal = [k for k in g if not np.array_equal(g[k], g2[k])]
    if unequal:
        raise RuntimeError(f"generic-adjoint: two warm sweeps differ in "
                           f"{unequal}")
    its = storage.lambda_iterations[:n_step][::-1]  # step order
    conv = storage.lambda_converged[:n_step][::-1]

    # one Jacobian, one ILU(0) update and one BiCGStab iteration of the
    # last step's transposed system, by CUDA events
    u1, u0 = storage.dofs_of(states[-1]), storage.dofs_of(states[-2])
    p, f = storage.params_f, forces[-1] if isinstance(forces, list) \
        else forces
    jac_ms = cuda_ms(lambda: storage._jac_blocks(u1, u0, p, dts[-1], f),
                     reps=3)
    ell = storage.comp.ell
    Jt = BlockELL(ell, ell_transpose(storage._jac_blocks(
        u1, u0, p, dts[-1], f), ell))
    pre = lam.preconditioner
    ilu_ms = cuda_ms(lambda: pre.update(Jt), reps=3)
    pst = pre.update(Jt)
    n, ndof = u1.shape
    b = torch.randn(n * ndof, device=u1.device, dtype=u1.dtype,
                    generator=torch.Generator(u1.device).manual_seed(0))
    k_its = 20
    bicg_ms = cuda_ms(lambda: bicgstab(
        lambda x: Jt.matvec(x.reshape(n, ndof)).reshape(-1), b,
        maxiter=k_its, rtol=0.0,
        precond=lambda x: pre.apply(pst, Jt, x.reshape(n, ndof)).reshape(-1)),
        reps=2) / k_its
    del Jt, pst
    torch.cuda.empty_cache()
    gt, gs = g["Transmissibilities"], g_stencil["Transmissibilities"]
    out = {
        "slice": "generic-adjoint", "cells": model.number_of_cells(),
        "dtype": "float32", "report_steps": n_step, "dt_s": ADJ_DT,
        "lambda_solver": "GenericKrylov(bicgstab, ILU0Preconditioner(), "
                         f"rtol={lam.rtol}, max_iterations="
                         f"{lam.max_iterations})",
        "sweep_cold_s": t_cold, "sweep_s": t_sweep,
        "overhead": t_sweep / forward_run_s,
        "forward_run_s": forward_run_s,
        "lambda_iterations_per_step": its,
        "lambda_converged_per_step": conv,
        "jacobian_ms": jac_ms, "ilu0_update_ms": ilu_ms,
        "bicgstab_iteration_ms": bicg_ms, "peak_mem_bytes": peak,
        "storage_setup_s": storage_s, "ell_transpose_setup_s":
            storage.setup_s,
        "grad_trans_rel_diff_vs_stencil": float(
            np.abs(gt - gs).max() / np.abs(gs).max()),
        "grad_trans_max_abs": float(np.abs(gt).max()),
        "warm_sweeps_bitwise_equal": True, "launches": launches,
    }
    log("# generic-adjoint: " + json.dumps(out))
    return out


def phase_generic_adjoint_dot(case, fd, states64, n_step=2, device="cuda"):
    """``adjoint-dot``'s float64 dot test with the sweep on the generic
    storage (ILU(0)-BiCGStab at rtol 1e-10, up to 2,000 iterations) on the
    same states and central differences (``fd``: h -> difference, from
    ``phase_adjoint_dot``): <∇G, δ> within 1e-3 of the difference at the
    smallest h."""
    from jutul.jl_tpu_torch import (
        AdjointStorage,
        solve_adjoint_sensitivities_jit,
    )

    model, state0, params, forces = case
    nc = model.domain.mesh._nc_base
    dts = [ADJ_DT] * n_step
    T0 = np.asarray(params["Transmissibilities"], np.float64)
    delta = T0 * np.random.default_rng(7).normal(size=T0.shape)
    t0 = time.perf_counter()
    storage = AdjointStorage(model, params, linear_solver=generic_lambda_solver(
        1e-10, 2000), device=device, dtype=torch.float64)
    g = solve_adjoint_sensitivities_jit(
        model, states64, dts, sat_objective(nc), parameters=params,
        state0=state0, forces=forces, storage=storage)["Transmissibilities"]
    torch.cuda.synchronize()
    dot = float(np.sum(g * delta))
    hs = sorted(fd, reverse=True)
    out = {"cells": model.number_of_cells(), "h": hs,
           "fd": [fd[h] for h in hs], "dot_f64": dot,
           "rel_err_f64_by_h": [abs(fd[h] - dot) / abs(dot) for h in hs],
           "rel_err_f64": abs(fd[hs[-1]] - dot) / abs(dot),
           "lambda_iterations": storage.lambda_iterations,
           "lambda_converged": storage.lambda_converged,
           "seconds": time.perf_counter() - t0}
    log("# generic-adjoint-dot (f64 card FD): " + json.dumps(out))
    if not out["rel_err_f64"] <= 1e-3:
        raise RuntimeError(f"generic-adjoint-dot: f64 gradient off by "
                           f"{out['rel_err_f64']:.3e} > 1e-3 at h = "
                           f"{hs[-1]}")
    return out


DICT_GRID = (32, 16, 16)  # 8,192 cells, 16,384 unknowns: direct λ-solves


def phase_dict_history_match(case, max_iterations=3, device="cuda"):
    """``DictParameters`` on the source-term flagship at DICT_GRID in
    float32 on the card, with the JAX package's defaults everywhere (no
    engine, no solver: the generic engine's ``DirectSolver`` forward and
    direct λ-solves, its 16,384 unknowns under the 20,000 of
    ``direct_limit``): Transmissibilities free (log scaler, rel 0.1-10),
    an l2 misfit on Saturations from a forward at the truth, 2 report
    steps of 6 h with srcwells' Newton tolerances, starting from 0.5x the
    truth. ``dopt.optimize(misfit, max_iterations)`` must lower the
    misfit."""
    from jutul.jl_tpu_torch import DictParameters, JutulCase, simulate
    from jutul.jl_tpu_torch.adjoint.objectives import l2_misfit_objective

    model, state0, params, forces = case

    def setup(p):  # the case from the nested parameter dict
        return JutulCase(model, [DT] * 2, forces, state0=state0,
                         parameters={**params, **p})

    newton = dict(tolerances={"mass_conservation/CNV": CNV_TOL,
                              "mass_conservation/MB": MB_TOL},
                  max_nonlinear_iterations=12, tol_factor_final_iteration=10.0)
    kw = dict(device=device, dtype=torch.float32, **newton)
    t0 = time.perf_counter()
    truth = simulate(state0, model, [DT] * 2, forces=forces,
                     parameters=params, info_level=-1, **kw)
    obs = [s["Saturations"] for s in truth.states]
    T = np.asarray(params["Transmissibilities"])
    dopt = DictParameters({"Transmissibilities": 0.5 * T}, setup,
                          verbose=False)
    dopt.free_optimization_parameter("Transmissibilities", rel_min=0.1,
                                     rel_max=10.0, scaler="log")
    torch.cuda.reset_peak_memory_stats()
    dopt.optimize(l2_misfit_objective({"Saturations": obs}),
                  max_iterations=max_iterations, sim_kwargs=kw)
    torch.cuda.synchronize()
    hist = dopt.history
    out = {"cells": model.number_of_cells(),
           "unknowns": 2 * model.number_of_cells(),
           "parameters": int(T.size), "values": hist.values,
           "projected_grad_norms": hist.grad_norms, "steps": hist.steps,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "wall_s": time.perf_counter() - t0}
    log("# dict-history-match: " + json.dumps(out))
    if not (len(hist.values) > 1 and np.all(np.isfinite(hist.values))
            and hist.values[-1] < hist.values[0]):
        raise RuntimeError(f"dict-history-match: misfit not lowered: "
                           f"{hist.values}")
    return out


TIGHT_F64 = dict(tolerances={"mass_conservation/CNV": 1e-8,
                             "mass_conservation/MB": 1e-10},
                 max_nonlinear_iterations=40)


def phase_generic_setup(case, h=1e-4, device="cuda"):
    """``solve_adjoint_generic`` on DICT_GRID's case in float64 on the
    card: x = log-Transmissibilities, mapped by ``exp`` in ``setup_fn``;
    G = dt Σ S_w² / nc over 2 report steps (tight f64 forwards with the
    defaults' engine and solver). <∇_x G, δ> (δ ~ N(0, 1), seed 5) against
    the central difference (G(x + hδ) − G(x − hδ)) / 2h within 1e-4."""
    from jutul.jl_tpu_torch import simulate, solve_adjoint_generic

    model, state0, params, forces = case
    nc = model.number_of_cells()
    dts = [DT] * 2
    G = sat_objective(nc)
    base = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in
            params.items()}
    base = {k: v.to(torch.float64) if v.is_floating_point() else v
            for k, v in base.items()}
    st0 = {k: torch.as_tensor(np.asarray(v, np.float64), device=device)
           for k, v in state0.items()}

    def setup_fn(x):
        return st0, {**base, "Transmissibilities": torch.exp(x)}

    x0 = np.log(np.asarray(params["Transmissibilities"], np.float64))
    delta = np.random.default_rng(5).normal(size=x0.shape)
    t0 = time.perf_counter()
    v, dx = solve_adjoint_generic(x0, setup_fn, model, dts, G, forces=forces,
                                  sim_kwargs=TIGHT_F64, device=device,
                                  dtype=torch.float64)

    def total(x):
        p = {**params, "Transmissibilities": np.exp(x)}
        res = simulate(state0, model, dts, forces=forces, parameters=p,
                       info_level=-1, device=device, dtype=torch.float64,
                       **TIGHT_F64)
        return _G_np(res.states, dts, nc)

    fd = (total(x0 + h * delta) - total(x0 - h * delta)) / (2 * h)
    dot = float(np.sum(dx * delta))
    out = {"cells": nc, "objective": v, "dot": dot, "fd": fd, "h": h,
           "rel_err": abs(fd - dot) / abs(dot),
           "seconds": time.perf_counter() - t0}
    log("# generic-setup (f64 card FD): " + json.dumps(out))
    if not out["rel_err"] <= 1e-4:
        raise RuntimeError(f"generic-setup: off by {out['rel_err']:.3e}")
    return out


def phase_force_gradient(dims=WELL_SMALL_EW, h=1e-4, device="cuda"):
    """``solve_adjoint_forces`` on the well model at ``dims`` in float64 on
    the card, per-step forces with the rate ramp, 2 report steps of 1.5 h:
    the injectors' rate gradient along δ (the rates times N(0, 1), seed 3)
    against the central difference of tight f64 forwards with the rates at
    (1 ± h δ), within 1e-5 relative."""
    from jutul.jl_tpu_torch import PhaseSourceTerm, simulate
    from jutul.jl_tpu_torch import solve_adjoint_forces

    model, state0, params, forces = build_well_flagship(*dims)
    nc = model.domain.mesh._nc_base
    dts = [ADJ_DT] * 2
    sched = rate_schedule(forces, 2)
    rates = [np.asarray(f["rate"].values, np.float64) for f in sched]
    delta = [r * np.random.default_rng(3 + i).normal(size=r.shape)
             for i, r in enumerate(rates)]
    G = sat_objective(nc)

    def run(sign):
        fs = [{**f, "rate": PhaseSourceTerm(f["rate"].cells,
                                            r + sign * h * d)}
              for f, r, d in zip(sched, rates, delta)]
        return simulate(state0, model, dts, forces=fs, parameters=params,
                        info_level=-1, device=device, dtype=torch.float64,
                        **TIGHT_F64).states

    t0 = time.perf_counter()
    states = run(0.0)
    grads = solve_adjoint_forces(model, states, dts, G, params, state0,
                                 sched, device=device, dtype=torch.float64)
    dot = sum(float(np.sum(gf["rate"].values.cpu().numpy() * d))
              for gf, d in zip(grads, delta))
    fd = (_G_np(run(1.0), dts, nc) - _G_np(run(-1.0), dts, nc)) / (2 * h)
    out = {"cells": model.number_of_cells(), "dot": dot, "fd": fd, "h": h,
           "rel_err": abs(fd - dot) / abs(dot),
           "grad_bhp_pressure": [float(gf["bhp"].pressure) for gf in grads],
           "seconds": time.perf_counter() - t0}
    log("# force-gradient (f64 card FD): " + json.dumps(out))
    if not out["rel_err"] <= 1e-5:
        raise RuntimeError(f"force-gradient: off by {out['rel_err']:.3e}")
    return out


def phase_eager_options(case, n_step=3, device="cuda"):
    """The eager loop's options on the well flagship at AB_GRID, stencil
    engine, float32 on the card, Jacobi GMG (bench's settings):
    ``n_step`` report steps writing per-step files to a temporary
    ``output_path``; ``restart=1`` from those files must give the
    uninterrupted run's final state bit for bit. Then one run with
    ``ConvergenceMonitorCuttingCriterion`` and a
    ``VariableChangeTimestepSelector`` beside the selectors, hooks
    counting iterations and ministeps, and ``extra_timing``: it must
    complete; its counts and phase timings are printed."""
    from jutul.jl_tpu_torch import (
        ConvergenceMonitorCuttingCriterion,
        Simulator,
        VariableChangeTimestepSelector,
        report_stats,
        timing_breakdown,
    )
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, params, forces = case
    sched = rate_schedule(forces, n_step)
    out = {"cells": model.number_of_cells()}
    with tempfile.TemporaryDirectory() as path:
        reset_launch_counts()
        t0 = time.perf_counter()
        full = Simulator(model, state0, params, use_stencil=True,
                         device=device).simulate(
            [DT] * n_step, forces=sched, output_path=path,
            **sim_config(16384))
        torch.cuda.synchronize()
        out["full_wall_s"] = time.perf_counter() - t0
        launches = launch_counts()
        files = sorted(os.listdir(path))
        rest = Simulator(model, state0, params, use_stencil=True,
                         device=device).simulate(
            [DT] * n_step, forces=sched, output_path=path, restart=1,
            **sim_config(16384))
    out["files"] = files
    if not all(r["success"] for r in full.reports + rest.reports) or \
            len(rest.states) != n_step - 1:
        raise RuntimeError("eager-options: a run failed")
    diff = [k for k, v in full.states[-1].items()
            if not np.array_equal(v, rest.states[-1][k])]
    if diff:
        raise RuntimeError(f"eager-options: the restart's final state "
                           f"differs in {diff}")
    out["restart_bitwise_equal"] = True
    _check_launches("eager-options", "eager-options", launches)
    counts = {"iterations": 0, "ministeps": 0}

    def post_it(state, err, it):
        counts["iterations"] += 1

    def post_mini(state, report):
        counts["ministeps"] += 1

    cfg = sim_config(16384)
    cfg["timestep_selectors"] = cfg["timestep_selectors"] + [
        VariableChangeTimestepSelector("Pressure", 10e5)]
    cutter = ConvergenceMonitorCuttingCriterion()
    t0 = time.perf_counter()
    res = Simulator(model, state0, params, use_stencil=True,
                    device=device).simulate(
        [DT] * n_step, forces=sched, cutting_criterion=cutter,
        post_iteration_hook=post_it, post_ministep_hook=post_mini,
        extra_timing=True, **cfg)
    torch.cuda.synchronize()
    st = report_stats(res.reports)
    if not all(r["success"] for r in res.reports) or \
            len(res.reports) != n_step:
        raise RuntimeError("eager-options: the monitored run failed")
    tb = timing_breakdown(st)
    out["monitored"] = {
        **{k: st[k] for k in ("ministeps", "newtons", "failed_ministeps",
                              "linear_iterations")},
        "cuts_by_criterion": sum(
            m.get("failure") == "cutting_criterion"
            for r in res.reports for m in r["ministeps"]),
        "hook_iterations": counts["iterations"],
        "hook_ministeps": counts["ministeps"],
        "timing_fractions": {k: v["fraction"] for k, v in tb.items()
                             if isinstance(v, dict)},
        "wall_s": time.perf_counter() - t0}
    out["launches"] = launches
    log("# eager-options: " + json.dumps(out))
    return out


def phase_generic_adjoint_cross_check(dims, stencil_grads, lam_rtol=1e-14,
                                      devices=("cuda", "cpu")):
    """The generic adjoint at ``dims`` (well models) in float64, λ by
    ILU(0)-BiCGStab at ``lam_rtol``, on the card and on the CPU, on
    ``phase_adjoint_cross_check``'s states: card against CPU within 1e-9,
    and against that phase's stencil-adjoint gradients within 1e-9."""
    from jutul.jl_tpu_torch import solve_adjoint_sensitivities_jit

    model, state0, params, forces = build_well_flagship(*dims)
    sched = rate_schedule(forces, 2)
    dts = [ADJ_DT] * 2
    states = stencil_grads.pop("states")
    G = sat_objective(model.domain.mesh._nc_base)
    grads = {dev: solve_adjoint_sensitivities_jit(
        model, states, dts, G, parameters=params, state0=state0,
        forces=sched, include_state0=True, linear_solver=(
            generic_lambda_solver(lam_rtol, 2000)), device=dev,
        dtype=torch.float64) for dev in devices}
    card, cpu = (grads[d] for d in devices)
    keys = ("Transmissibilities", "FluidVolume", "state0")
    out = {"card_vs_cpu": {k: float(
        np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max())
        for k in keys},
        "generic_vs_stencil": {k: float(
            np.abs(card[k] - stencil_grads[k]).max()
            / np.abs(stencil_grads[k]).max()) for k in keys}}
    log(f"# generic-adjoint cross-check ({'x'.join(map(str, dims))}, "
        "f64): " + json.dumps(out))
    if not all(v <= 1e-9 for d in out.values() for v in d.values()):
        raise RuntimeError(f"generic-adjoint cross-check: gradients "
                           f"differ: {out}")
    return out


# ---------------------------------------------------------------------------
# the transport slice: BASELINE.json configuration 2 on an UnstructuredMesh
# ---------------------------------------------------------------------------
def transport_solver(pkg=None):
    """weno-transport's linear solver: ILU(0)-GMRES(20) at rtol 1e-4."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    return pkg.GenericKrylov("gmres", pkg.ILU0Preconditioner(), rtol=1e-4,
                             max_iterations=200)


def nfvm_solver(pkg=None):
    """nfvm-pressure's linear solver: GMRES(20) at rtol 1e-4 preconditioned
    by the port's AMGPreconditioner with its Chebyshev smoother. On NTPFA
    systems of this case (256 x 256, f64, CPU) GMRES(20) with the
    default Jacobi-smoothed AMG leaves 0.56 of the residual after 200
    iterations and with ILU(0) 0.99999; with the Chebyshev smoother it
    converges in 64 (37 at the second Newton)."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    return pkg.GenericKrylov("gmres", pkg.AMGPreconditioner(
        smoother="chebyshev"), rtol=1e-4, max_iterations=200)


def build_transport_mesh(nx, ny, amp=0.2):
    """``perturbed_quad_mesh(nx, ny, amp=amp)`` with its geometry, timed
    on the host."""
    t0 = time.perf_counter()
    mesh = perturbed_quad_mesh(nx, ny, amp=amp)
    t1 = time.perf_counter()
    geo = mesh.tpfv_geometry()
    t2 = time.perf_counter()
    out = {"cells": geo.n_cells, "interior_faces": geo.n_faces,
           "boundary_faces": geo.n_boundary_faces, "node_offset": amp,
           "mesh_s": t1 - t0, "geometry_s": t2 - t1}
    log("# transport mesh: " + json.dumps(out))
    return mesh, out


def _progress(name, t0):
    """A post-ministep hook logging each accepted ministep."""
    return lambda state, rep: log(
        f"  {name}: ministep dt {rep['dt']:.4g}, {rep['iterations']} "
        f"Newtons, {rep['linear_iterations']} linear its, "
        f"{time.perf_counter() - t0:.1f} s")


def _transport_run(name, model, state0, params, dts, solver, setup,
                   **newton):
    """One eager ``Simulator(use_stencil=False)`` run in float32 on the
    card, its host set-up timed apart (ELL tables with the sum plans and
    ILU(0)'s transpose partners; AMG's hierarchy where the preconditioner
    has one), then one assemble, one preconditioner update and one GMRES
    iteration timed by CUDA events on the last ministep's system. No
    kernel may launch. Returns (sim, res, record)."""
    from jutul.jl_tpu_torch import Simulator, report_stats, simulator_config
    from jutul.jl_tpu_torch.linsolve.krylov import gmres
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    nc = model.number_of_cells()
    sim = Simulator(model, state0, params, use_stencil=False)  # the card
    t0 = time.perf_counter()
    ell = sim.compiled.ell
    ell.partner_slots()
    setup["ell_tables_s"] = time.perf_counter() - t0
    pre = solver.preconditioner
    if hasattr(pre, "_symbolic"):
        t0 = time.perf_counter()
        pre._symbolic(ell)
        setup["amg_hierarchy_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.simulate(dts, linear_solver=solver, info_level=-1,
                       post_ministep_hook=_progress(name, t0), **newton)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = report_stats(res.reports)
    if not all(r["success"] for r in res.reports) or \
            len(res.reports) != len(dts):
        raise RuntimeError(f"{name}: a report step failed")
    for k, v in res.states[-1].items():
        if not np.all(np.isfinite(v)):
            raise RuntimeError(f"{name}: final {k} not finite")
    if any(launches.values()):
        raise RuntimeError(f"{name}: launched {launches}")
    comp = sim.compiled
    full0 = merge_state(res.final_ministep_start_state, sim.parameters)
    dt = res.final_ministep_dt
    assemble_ms = cuda_ms(lambda: comp.assemble(full0, full0, dt), reps=3)
    r, J, _ = comp.assemble(full0, full0, dt)
    update_ms = cuda_ms(lambda: pre.update(J), reps=3)
    pstate = pre.update(J)
    n = r.shape[0]
    b = (-r).reshape(-1).contiguous()
    gm_its = 20  # one full GMRES(20) cycle at rtol 0
    gmres_iter_ms = cuda_ms(lambda: gmres(
        lambda v: J.matvec(v.reshape(n, -1)).reshape(-1), b, restart=20,
        maxiter=gm_its, rtol=0.0,
        precond=lambda v: pre.apply(pstate, J, v.reshape(n, -1)).reshape(-1)),
        reps=2) / gm_its
    del r, J, pstate
    torch.cuda.empty_cache()
    newtons = stats["newtons"]
    max_it = newton.get("max_nonlinear_iterations",
                        simulator_config()["max_nonlinear_iterations"])
    out = {"slice": name, "engine": "generic block-ELL (use_stencil=False)",
           "cells": nc, "faces": comp.model.data_domain.geometry.n_faces,
           "stencil_width": int(comp._meta[-1]["K"]),
           "ell_slots": int(ell.n_slots), "path": "eager (simulate)",
           "dtype": "float32", "report_steps": len(dts),
           "report_dt": float(dts[0]),
           "ministeps": stats["ministeps"], "newtons": newtons,
           "failed_ministeps": stats["failed_ministeps"],
           "linear_iterations": stats["linear_iterations"], "wall_s": wall,
           "s_per_newton": wall / newtons,
           "cell_newton_its_per_s": nc * newtons / wall,
           "newtons_in_capped_ministeps": sum(
               m["iterations"] for r_ in res.reports for m in r_["ministeps"]
               if m["iterations"] >= max_it),
           "peak_mem_bytes": peak, "launches": launches, "host_setup": setup,
           "assemble_ms": assemble_ms, "precond_update_ms": update_ms,
           "gmres_iteration_ms": gmres_iter_ms,
           "per_ministep": [[m["dt"], m["iterations"], m["linear_iterations"],
                             m["success"]] for r_ in res.reports
                            for m in r_["ministeps"]]}
    return sim, res, out


def phase_transport_f64_verify(sim, res, name):
    """The last accepted ministep's residual re-assembled in float64 on the
    card (integer tables kept): Max |r| within 10x the equation's default
    tolerance."""
    pr = {k: v.double() if v.is_floating_point() else v
          for k, v in sim.parameters.items()}
    st = _to64(res.final_state_device)
    r, _, full = sim.compiled.assemble(
        sim._merge(st, pr),
        sim._merge(_to64(res.final_ministep_start_state), pr),
        res.final_ministep_dt, None)
    tol = next(iter(sim.model.equations.values())).default_tolerance(
        sim.model)
    out = {"rows": r.shape[0], "f64_max_abs_residual": float(r.abs().max()),
           "tolerance": tol}
    log(f"# {name} f64 verify: " + json.dumps(out))
    if not out["f64_max_abs_residual"] <= 10 * tol:
        raise RuntimeError(f"{name} f64 verify: residual out of bound: {out}")
    return out


def phase_weno_transport(mesh, mesh_setup, n_step=3):
    """``weno-transport``: BASELINE.json configuration 2 at full width —
    ``TransportSystem("weno")`` on the 1024 x 1024 quad ``UnstructuredMesh``
    ``mesh`` (``build_transport``), float32 on the card, ``n_step`` report
    steps of 4h/pi through the eager ``Simulator(use_stencil=False)
    .simulate`` with ILU(0)-GMRES(20) at rtol 1e-4 and the equation's
    default Max tolerance (1e-6). Host set-up split (mesh, geometry, WENO
    tables, ELL tables), then the f64 verify, the mass drift
    |sum VC - sum VC0| / sum VC0 (summed in float64) and C within
    [-0.15, 1.15]. Returns (sim, res, record, state0)."""
    nx, ny = TRANSPORT_GRID
    t0 = time.perf_counter()
    model, state0, params = build_transport(nx, ny, "weno", mesh=mesh)
    setup = dict(mesh_setup, model_and_weno_tables_s=time.perf_counter() - t0)
    dts = [transport_dt(nx)] * n_step
    sim, res, out = _transport_run("weno-transport", model, state0, params,
                                   dts, transport_solver(), setup)
    out["f64_verify"] = phase_transport_f64_verify(sim, res,
                                                   "weno-transport")
    V = np.asarray(params["Volume"], np.float64)
    C0 = np.asarray(state0["C"], np.float64)
    C = np.asarray(res.states[-1]["C"], np.float64)
    m0 = float(np.sum(V * C0))
    out["mass_drift"] = abs(float(np.sum(V * C)) - m0) / m0
    out["C_range"] = [float(C.min()), float(C.max())]
    log("# weno-transport: " + json.dumps(out))
    if not (-0.15 < out["C_range"][0] and out["C_range"][1] < 1.15):
        raise RuntimeError(f"weno-transport: C out of [-0.15, 1.15]: "
                           f"{out['C_range']}")
    return sim, res, out, state0


CONDITIONING_GRID = (256, 256)


def phase_stencil_conditioning():
    """``stencil-conditioning``: why the transport slice runs on the
    unperturbed quad mesh. On ``perturbed_quad_mesh`` (node offsets
    0.2 h) the WENO and NFVM stencils take the first admissible subset of a
    cell's neighbours, and pairs of opposite neighbours — collinear, and
    rejected, on the quad mesh — pass WENO's |det G| >= 1e-8 scale^2 test
    and NFVM's positivity test once nearly collinear: the reconstruction
    weights |gamma| and the NFVM weight sums reach 1e7. Flat regions weight
    every WENO candidate alike, so the Jacobian carries them, and an f32
    NFVM flux loses ~tsum ulps. At CONDITIONING_GRID on both meshes, in
    float64 on the card: max |gamma| and the share of candidates above 2,
    max and median NFVM tsum and the share above 100, and ILU(0)-GMRES(20)'s
    relative residual after 100 iterations (rtol 1e-8) on WENO's first
    Newton system (the initial state over one 4h/pi step)."""
    from jutul.jl_tpu_torch import (GenericKrylov, ILU0Preconditioner,
                                    compile_model, from_numpy)
    from jutul.jl_tpu_torch.discretization.nfvm import nfvm_discretize
    from jutul.jl_tpu_torch.models.setup import merge_state

    nx, ny = CONDITIONING_GRID
    out = {"cells": nx * ny}
    for tag, amp in (("perturbed", 0.2), ("unperturbed", 0.0)):
        mesh = perturbed_quad_mesh(nx, ny, amp=amp)
        model, st0, params = build_transport(nx, ny, "weno", mesh=mesh)
        full = merge_state(from_numpy(st0, "cuda", torch.float64),
                           from_numpy(params, "cuda", torch.float64))
        r, J, _ = compile_model(model).assemble(full, full, transport_dt(nx))
        _, stats = GenericKrylov("gmres", ILU0Preconditioner(), rtol=1e-8,
                                 max_iterations=100).solve(J, r)
        g = np.abs(np.concatenate([params["weno_gamma_l"],
                                   params["weno_gamma_r"]])).max(axis=-1)
        live = np.concatenate([params["weno_mask_l"],
                               params["weno_mask_r"]]) > 0
        geo = mesh.tpfv_geometry()
        fd = nfvm_discretize(geo, nfvm_permeability(geo.n_cells))
        t = np.concatenate([fd["tsum_l"], fd["tsum_r"]])
        out[tag] = {"weno_max_abs_gamma": float(g.max()),
                    "weno_share_gamma_above_2": float((g[live] > 2).mean()),
                    "weno_gmres_rel_residual_100": float(stats["residual"])
                    / float(torch.linalg.vector_norm(r)),
                    "nfvm_max_tsum": float(t.max()),
                    "nfvm_median_tsum": float(np.median(t)),
                    "nfvm_share_tsum_above_100": float((t > 100).mean())}
        del r, J
    log("# stencil-conditioning: " + json.dumps(out))
    return out


def phase_weno_transport_fused(sim, state0, rtol=1e-3):
    """``weno-transport-fused``: the slice's first Newton system (its
    initial state over the first report step) solved by
    ``GenericKrylov("bicgstab", ILU0Preconditioner(),
    use_fused_body=True)`` (K6/K7 on the flat vectors) and by the plain
    chain. Both converge, true residuals (float64) within 10 rtol; K6 and
    K7 launch once per fused iteration, no stencil kernel ever, the plain
    chain nothing."""
    from jutul.jl_tpu_torch import (BlockELL, GenericKrylov,
                                    ILU0Preconditioner, from_numpy)
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    full0 = merge_state(from_numpy(state0, sim.device, sim.dtype),
                        sim.parameters)
    r, J, _ = sim.compiled.assemble(full0, full0,
                                    transport_dt(TRANSPORT_GRID[0]))
    J64 = BlockELL(J.structure, J.blocks.double())
    b = -r.double()
    bnorm = float(torch.linalg.vector_norm(b))
    out = {}
    for tag, fused in (("fused", True), ("plain", None)):
        solver = GenericKrylov("bicgstab", ILU0Preconditioner(), rtol=rtol,
                               max_iterations=200, use_fused_body=fused)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        du, stats = solver.solve(J, r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        true_rel = float(torch.linalg.vector_norm(
            b - J64.matvec(du.double()))) / bnorm
        out[tag] = {"iterations": stats["iterations"],
                    "converged": bool(stats["converged"]),
                    "true_rel_residual": true_rel, "solve_s": wall,
                    "launches": launches}
        if not out[tag]["converged"] or true_rel > 10 * rtol:
            raise RuntimeError(f"weno-transport-fused {tag}: not "
                               f"converged: {out}")
    its = out["fused"]["iterations"]
    lf = out["fused"]["launches"]
    _check_launches("weno-transport-fused", "weno-transport-fused", lf)
    if not lf["fused_alpha_s"] == its == lf["fused_omega_update"]:
        raise RuntimeError(f"weno-transport-fused: K6/K7 launches {lf} "
                           f"differ from its {its} iterations")
    if any(out["plain"]["launches"].values()):
        raise RuntimeError(f"weno-transport-fused: the plain chain launched "
                           f"{out['plain']['launches']}")
    out["launches"] = lf
    log("# weno-transport-fused: " + json.dumps(out))
    del r, J, J64
    torch.cuda.empty_cache()
    return out


def phase_weno_engine_check(sim, res, state0):
    """``weno-engine-check``, float64 on the card at full size:
    ``HelperSimulator.model_residual`` on the slice's last ministep equals
    ``CompiledModel.residual`` bit for bit, and a second assemble gives
    equal bits; the assembled BlockELL J v against ``torch.func.jvp``
    through ``model_residual`` for a seeded v, relative to max |jvp|, at
    the slice's first Newton system (within 1e-12) and at its last
    ministep (reported, bounded by JV_LAST_BAR)."""
    from jutul.jl_tpu_torch import HelperSimulator
    from jutul.jl_tpu_torch.models.setup import merge_state

    f64 = torch.float64
    helper = HelperSimulator(sim.model, sim.parameters, dtype=f64)
    comp = helper.comp
    x = helper.vectorize_state(res.final_state_device)
    x0 = helper.vectorize_state(res.final_ministep_start_state)
    dt = res.final_ministep_dt
    r_helper = helper.model_residual(x, x0, dt)
    full = merge_state(helper.devectorize_state(x), helper.parameters)
    full0 = merge_state(helper.devectorize_state(x0), helper.parameters)
    r_comp = comp.residual(full, full0, dt).reshape(-1)
    r, J, _ = comp.assemble(full, full0, dt)
    r2, J2, _ = comp.assemble(full, full0, dt)
    out = {"cells": x.numel(), "dtype": "float64",
           "residual_bitwise": bool(torch.equal(r_helper, r_comp)
                                    and torch.equal(r.reshape(-1), r_comp)),
           "assemble_bitwise": bool(torch.equal(r, r2)
                                    and torch.equal(J.blocks, J2.blocks))}
    del J, J2, r2
    v = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(12), device="cuda", dtype=f64)
    xi = helper.vectorize_state(state0)
    for tag, y, y0, dt_ in (("first", xi, xi, transport_dt(
            TRANSPORT_GRID[0])), ("last", x, x0, dt)):
        _, jv = torch.func.jvp(lambda z: helper.model_residual(z, y0, dt_),
                               (y,), (v,))
        _, J, _ = comp.assemble(
            merge_state(helper.devectorize_state(y), helper.parameters),
            merge_state(helper.devectorize_state(y0), helper.parameters),
            dt_)
        yv = J.matvec(v.reshape(-1, 1)).reshape(-1)
        out[f"jv_rel_{tag}"] = rel_err(yv, jv)
        del jv, yv, J
    log("# weno-engine-check: " + json.dumps(out))
    if not (out["residual_bitwise"] and out["assemble_bitwise"]
            and out["jv_rel_first"] <= 1e-12
            and out["jv_rel_last"] <= JV_LAST_BAR):
        raise RuntimeError(f"weno-engine-check failed: {out}")
    torch.cuda.empty_cache()
    return out


# J v against the jvp at the slice's last ministep: the same f64
# derivative summed in two orders. Where WENO's smoothness beta nears its
# eps the weight derivatives cancel terms ~1e7 above the result, so the
# two differ by a few 1e-9 of max |jvp| — on the card and on the CPU alike
# (PERF.md §6; 3e-16 between the card's and the CPU's own results).
JV_LAST_BAR = 1e-7


def phase_nfvm_pressure(mesh, mesh_setup, n_step=2):
    """``nfvm-pressure``: ``NFVMPressureSystem("ntpfa", compressibility=1)``
    on the shared quad mesh with the full-tensor ``nfvm_permeability``
    (``build_nfvm``), float32 on the card, ``n_step`` report steps of
    NFVM_DT, ``nfvm_solver``; reported as weno-transport, with its f64
    verify. Newton: the bench's f32-floor settings (12 iterations, a
    ministep at the cap accepted within 10x the tolerance): one f32 ulp of
    p ~ 1 moves a row by ~T 1.2e-7 with T ~ 10 per face, so the f32
    residual stalls near 5e-6 against the 1e-6 tolerance."""
    nx, ny = TRANSPORT_GRID
    t0 = time.perf_counter()
    model, state0, params = build_nfvm(nx, ny, "ntpfa", mesh=mesh)
    setup = dict(mesh_setup, model_and_nfvm_tables_s=time.perf_counter() - t0)
    sim, res, out = _transport_run("nfvm-pressure", model, state0, params,
                                   [NFVM_DT] * n_step, nfvm_solver(), setup,
                                   max_nonlinear_iterations=12,
                                   tol_factor_final_iteration=10.0)
    out["solver"] = ("GenericKrylov(gmres, AMGPreconditioner(smoother="
                     "'chebyshev'), rtol=1e-4)")
    out["f64_verify"] = phase_transport_f64_verify(sim, res, "nfvm-pressure")
    p = np.asarray(res.states[-1]["Pressure"], np.float64)
    out["p_range"] = [float(p.min()), float(p.max())]
    log("# nfvm-pressure: " + json.dumps(out))
    del sim, res
    torch.cuda.empty_cache()
    return out


CROSS_GRID = (24, 20)
# node offsets of the small cases run with Krylov solvers: WENO and
# avgMPFA on the unperturbed quad mesh (their systems on the perturbed one
# defeat the package's Krylov solvers: phase_stencil_conditioning), SPU
# and NTPFA on the perturbed one
CROSS_AMP = {"spu": 0.2, "weno": 0.0, "avgmpfa": 0.0, "ntpfa": 0.2}


def transport_cross_case(scheme, pkg=None, grid=CROSS_GRID, amp=None):
    """(model, state0, parameters, dts) of a small transport case for
    ``scheme`` on ``perturbed_quad_mesh(*grid, amp=amp)`` (default
    CROSS_AMP[scheme]): spu / weno (``build_transport``, 3 steps of 0.05 x
    4h/pi: at larger steps WENO's Newton needs many cuts on these coarse
    meshes, in both packages) or avgmpfa / ntpfa (``build_nfvm`` with a
    Gaussian of width 0.2, resolved on a coarse mesh, 3 steps of 1e-3)."""
    nx, ny = grid
    amp = CROSS_AMP[scheme] if amp is None else amp
    mesh = perturbed_quad_mesh(nx, ny, pkg, amp=amp)
    if scheme in ("spu", "weno"):
        return (*build_transport(nx, ny, scheme, pkg=pkg, mesh=mesh),
                [0.05 * transport_dt(nx)] * 3)
    return (*build_nfvm(nx, ny, scheme, pkg=pkg, mesh=mesh, width=0.2),
            [1e-3] * 3)


def small_transport_solver(scheme, pkg=None):
    """The small cases' Krylov solver at rtol 1e-10: ILU(0)-GMRES(20) for
    the transport schemes, AMG-GMRES(20) for NFVM (ILU(0)'s two-point
    factorization does not converge on the NFVM systems, in either
    package)."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    pre = pkg.ILU0Preconditioner() if scheme in ("spu", "weno") \
        else pkg.AMGPreconditioner()
    return pkg.GenericKrylov("gmres", pre, rtol=1e-10, max_iterations=400)


def phase_transport_cross_check():
    """``transport-cross-check``: SPU, WENO, NFVM avgMPFA and NTPFA at
    CROSS_GRID in float64, card against CPU with
    ``small_transport_solver``: identical counts, states within 1e-9; two
    card runs bitwise equal."""
    from jutul.jl_tpu_torch import Simulator

    out = {}
    for scheme in ("spu", "weno", "avgmpfa", "ntpfa"):
        model, state0, params, dts = transport_cross_case(scheme)
        runs = []
        for dev in ("cuda", "cuda", "cpu"):
            sim = Simulator(model, state0, params, use_stencil=False,
                            device=dev, dtype=torch.float64)
            res = sim.simulate(dts, info_level=-1,
                               linear_solver=small_transport_solver(scheme))
            runs.append(res)
        counts = [[(m["iterations"], m["linear_iterations"], m["success"])
                   for r in res.reports for m in r["ministeps"]]
                  for res in runs]
        key = next(iter(model.primary_variables))
        dev = max(float(np.max(np.abs(a[key] - b[key]))) for a, b in
                  zip(runs[0].states, runs[2].states))
        bitwise = all(np.array_equal(a[key], b[key]) for a, b in
                      zip(runs[0].states, runs[1].states))
        out[scheme] = {"ministeps": len(counts[2]),
                       "newtons": sum(c[0] for c in counts[2]),
                       "linear_iterations": sum(c[1] for c in counts[2]),
                       "max_abs_dev": dev, "card_repeat_bitwise": bitwise}
        if counts[0] != counts[2] or counts[0] != counts[1] or \
                not (dev <= 1e-9 and bitwise):
            raise RuntimeError(f"transport cross-check {scheme}: card "
                               f"{counts[0]} CPU {counts[2]}: {out[scheme]}")
    log(f"# transport cross-check card vs CPU "
        f"({'x'.join(map(str, CROSS_GRID))}, f64): " + json.dumps(out))
    return out


COMPOSITE_GRID = (64, 64)


def composite_solver(pkg):
    """helpers-on-card's composite runs: ILU(0)-GMRES(20) at rtol 1e-12
    (WENO on the quad mesh; a dense solve of its 8,192 unknowns per Newton
    is slow on the host)."""
    return pkg.GenericKrylov("gmres", pkg.ILU0Preconditioner(), rtol=1e-12,
                             max_iterations=400)


def _tabulated_flagship(tabulated, dims=DICT_GRID):
    """The source-term flagship at ``dims`` (``build_flagship``), its
    relative permeabilities optionally replaced by a
    ``UnaryTabulatedVariable`` of 2,001 knots of the model's own Corey
    curves (capped at both ends)."""
    from jutul.jl_tpu_torch import UnaryTabulatedVariable

    case = build_flagship(*dims)
    model = case[0]
    if tabulated:
        s = np.linspace(0.0, 1.0, 2001)
        kr = model.secondary_variables["RelativePermeabilities"].evaluate(
            model, Saturations=torch.as_tensor(np.stack([s, s], axis=1)))
        model.secondary_variables["RelativePermeabilities"] = \
            UnaryTabulatedVariable("Saturations", s,
                                   [kr[:, 0].numpy(), kr[:, 1].numpy()],
                                   cap_start=True, cap_end=True)
    return case


def _tight_generic_f64(device):
    """Two 6 h report steps of the flagship in float64 on ``device``:
    tight tolerances (TIGHT_F64) and CPR-GMRES at rtol 1e-10."""
    from jutul.jl_tpu_torch import CPRPreconditioner, GenericKrylov

    return dict(info_level=-1, device=device, dtype=torch.float64,
                linear_solver=GenericKrylov("gmres", CPRPreconditioner(),
                                            rtol=1e-10, max_iterations=200),
                **TIGHT_F64)


def _max_dev(sa, sb):
    """Largest deviation of two state lists: Pressure relative, the rest
    absolute."""
    return max(float(np.max(np.abs(a[k] / b[k] - 1 if k == "Pressure"
                                   else a[k] - b[k])))
               for a, b in zip(sa, sb) for k in b)


def phase_helpers_on_card(h=1e-4):
    """``helpers-on-card``, float64 on the card, each case with its own
    check and against the port's CPU run (within 1e-9):
    - ``run_composite`` at COMPOSITE_GRID (heat + WENO tracer on the
      quad mesh, 3 steps, ``composite_solver``): the composite within
      1e-10 of the two standalone runs;
    - the ``UnaryTabulatedVariable`` relperm in DICT_GRID's flagship (2
      steps, tight): within 1e-5 of the analytic relperm's run (pressure
      relative, saturations absolute), as tests/test_tabulated.py holds it;
    - ``data_domain_parameter_gradient`` of that case's generic-adjoint
      Transmissibilities gradient (G = dt sum S_w^2 / nc, λ by
      ILU(0)-BiCGStab at rtol 1e-14) against central differences of G
      along a seeded log-permeability direction at h = 1e-4 and 2h,
      extrapolated to fourth order, within 1e-5.
    The last two compare card and CPU at WELL_SMALL_EW: the DICT_GRID runs
    are slow on the host."""
    from jutul.jl_tpu_torch import (GenericKrylov, ILU0Preconditioner,
                                    compute_face_trans,
                                    data_domain_parameter_gradient,
                                    simulate, solve_adjoint_sensitivities)

    out = {}
    t0 = time.perf_counter()
    runs = {dev: run_composite(COMPOSITE_GRID, "weno", amp=0.0,
                               solver=composite_solver, device=dev,
                               dtype=torch.float64)
            for dev in ("cuda", "cpu")}
    (cg, hg, tg), (cc, _, _) = runs["cuda"], runs["cpu"]
    out["composite"] = {
        "cells": int(np.prod(COMPOSITE_GRID)),
        "newtons": sum(m["iterations"] for r in cg.reports
                       for m in r["ministeps"]),
        "card_vs_cpu": _max_dev(cg.states, cc.states),
        "vs_standalone": max(
            float(np.max(np.abs(cg.states[-1]["T"] - hg.states[-1]["T"]))),
            float(np.max(np.abs(cg.states[-1]["C"] - tg.states[-1]["C"])))),
        "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    tab = {}
    for tag, tabulated, dev, dims in (
            ("tab", True, "cuda", DICT_GRID),
            ("analytic", False, "cuda", DICT_GRID),
            ("tab_small", True, "cuda", WELL_SMALL_EW),
            ("tab_small_cpu", True, "cpu", WELL_SMALL_EW)):
        model, state0, params, forces = _tabulated_flagship(tabulated, dims)
        res = simulate(state0, model, [DT] * 2,
                       forces=rate_schedule(forces, 2), parameters=params,
                       **_tight_generic_f64(dev))
        if not all(r["success"] for r in res.reports):
            raise RuntimeError(f"helpers-on-card: {tag} failed")
        tab[tag] = res.states
    dev_p = max(float(np.max(np.abs(a["Pressure"] / b["Pressure"] - 1)))
                for a, b in zip(tab["tab"], tab["analytic"]))
    dev_s = max(float(np.max(np.abs(a["Saturations"] - b["Saturations"])))
                for a, b in zip(tab["tab"], tab["analytic"]))
    out["tabulated_relperm"] = {
        "cells": int(np.prod(DICT_GRID)), "vs_analytic_pressure_rel": dev_p,
        "vs_analytic_saturations_abs": dev_s,
        "card_vs_cpu": _max_dev(tab["tab_small"], tab["tab_small_cpu"]),
        "seconds": time.perf_counter() - t0}

    def pulled_back(dims, devs):
        """The permeability gradient of G at ``dims`` on each device, from
        one card forward's states; with the case and its forward."""
        model, state0, params, forces = build_flagship(*dims)
        nc = model.number_of_cells()
        schedule = rate_schedule(forces, 2)
        fwd = simulate(state0, model, [DT] * 2, forces=schedule,
                       parameters=params, **_tight_generic_f64("cuda"))
        grads = {}
        for dev in devs:
            g = solve_adjoint_sensitivities(
                model, fwd.states, [DT] * 2, sat_objective(nc),
                parameters=params, state0=state0, forces=schedule,
                device=dev, dtype=torch.float64,
                linear_solver=GenericKrylov("bicgstab", ILU0Preconditioner(),
                                            rtol=1e-14, max_iterations=2000))
            grads[dev] = data_domain_parameter_gradient(
                model, {"Transmissibilities": g["Transmissibilities"]},
                fields=["permeability"], device=dev)["permeability"]
        return grads, (model, state0, params, schedule)

    t0 = time.perf_counter()
    grads, (model, state0, params, schedule) = pulled_back(DICT_GRID,
                                                           ("cuda",))
    nc = model.number_of_cells()
    perm = np.asarray(model.data_domain["permeability"], np.float64)
    delta = np.random.default_rng(5).normal(size=perm.shape)
    geo = model.data_domain.geometry

    def total(sign):
        p = {**params, "Transmissibilities": compute_face_trans(
            geo, perm * np.exp(sign * h * delta))}
        res = simulate(state0, model, [DT] * 2, forces=schedule,
                       parameters=p, **_tight_generic_f64("cuda"))
        return _G_np(res.states, [DT] * 2, nc)

    # central differences at h and 2h, extrapolated (Richardson): the
    # second-order difference alone is 1.2e-5 off at h = 1e-4
    fd_h = (total(1.0) - total(-1.0)) / (2 * h)
    fd_2h = (total(2.0) - total(-2.0)) / (4 * h)
    fd = (4.0 * fd_h - fd_2h) / 3.0
    dot = float(np.sum(grads["cuda"] * perm * delta))
    small, _ = pulled_back(WELL_SMALL_EW, ("cuda", "cpu"))
    out["dd_gradient"] = {
        "cells": nc, "dot": dot, "fd": fd, "fd_h": fd_h, "fd_2h": fd_2h,
        "h": h,
        "rel_err": abs(fd - dot) / abs(dot),
        "card_vs_cpu": float(np.max(np.abs(small["cuda"] - small["cpu"]))
                             / np.max(np.abs(small["cpu"]))),
        "seconds": time.perf_counter() - t0}
    log("# helpers-on-card: " + json.dumps(out))
    bad = [k for k, v in out.items() if not v["card_vs_cpu"] <= 1e-9]
    if bad or not (out["composite"]["vs_standalone"] <= 1e-10
                   and dev_p <= 1e-5 and dev_s <= 1e-5
                   and out["dd_gradient"]["rel_err"] <= 1e-5):
        raise RuntimeError(f"helpers-on-card failed ({bad}): {out}")
    return out


# ---------------------------------------------------------------------------
# the meshes slice: an extruded layered reservoir with trajectory wells, its
# partitioned coarse model and a cut fault, on the generic engine
# ---------------------------------------------------------------------------
LAYER_GRID = (256, 256, 16)  # map cells x, y and layers: 1,048,576 cells
LAYER_SMALL = (8, 8, 4)  # the card-vs-CPU cross-check
CUT_GRID_LIMIT_S = 60.0  # the cut runs at full width if it builds this fast
CUT_GRID_REDUCED = (128, 128, 16)
MAP_SIDE = 1000.0  # m, the square map's side
COARSE_BLOCKS = 16384  # 64 fine cells per coarse block at LAYER_GRID
FAULT_NORMAL = (1.0, 0.2, 0.5)  # the cut's normal: a dipping fault plane
SLIVER_FRACTION = 0.01  # cut parts below this share of a cell are merged
WELL_WI = 2.5e-13  # the flagship's completion index (_well_case)
# build_well_flagship(*GRID)'s pore volume and injection rate per injector
FLAGSHIP_PV = 0.25 * 200.0 * 50.0 * 10.0
FLAGSHIP_Q = 0.2 * (100.0 / 128) ** 2 * (10.0 / 64) * 0.25 * 1000.0 / 21600.0


def _timing(pkg):
    return importlib.import_module(pkg.__name__ + ".utils.timing")


def layered_reservoir(nx, ny, nl, pkg=None, seed=0, fault=False):
    """An SPE10-style layered reservoir through ``pkg``'s mesh API (default
    the port): the moved nx x ny quad map of ``perturbed_quad_mesh`` (seed
    ``seed``) scaled to a MAP_SIDE square, extruded by ``extrude_mesh`` into
    ``nl`` layers of seeded thicknesses in [2, 10] m (z down from 0);
    per-layer log-normal permeability means with per-cell noise, assigned
    through the ``"layers"`` cell tags and read back from them; porosity
    and initial water saturation per cell; the bench flagship's fluid,
    gravity and initial pressure (200 bar - rho g z + a smooth lateral
    field). ``fault``: the extruded mesh cut by one dipping ``PlaneCut``
    through the reservoir's centre, each cut cell's slivers merged back
    (``_merge_slivers``); each part of a cut cell keeps its parent's
    properties. Five wells by ``find_enclosing_cells`` on
    trajectories: four vertical injectors near the corners, one producer
    deviated through three segments across the middle; WellSpecs with the
    flagship's completion index, through ``setup_well_graph_model``; rate
    control at the flagship's rate scaled by the pore volume, the
    producer on the flagship's BHP control. Host phases are timed by
    ``pkg``'s ``utils/timing`` scopes when they are enabled. Returns a
    dict: model, state0, params, forces (host numpy), and the mesh, its
    layer interfaces, the cell fields, the well cells, the pore volume,
    the uncut volume and the number of cells the cut added."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    T = _timing(pkg)
    CELLS = importlib.import_module(pkg.__name__ + ".core.entities").CELLS
    W = importlib.import_module(pkg.__name__ + ".models.wells")
    D = importlib.import_module(pkg.__name__ + ".models.darcy")
    BAR, DARCY = pkg.si_units("bar", "darcy")
    rng = np.random.default_rng(seed)
    L = MAP_SIDE
    z = np.concatenate([[0.0], np.cumsum(rng.uniform(2.0, 10.0, nl))])
    H = z[-1]
    with T.tic("2-D map"):
        m = perturbed_quad_mesh(nx, ny, pkg, seed=seed)
        m2 = pkg.UnstructuredMesh(m.points * L, m.face_nodes,
                                  m.face_neighbors, m.boundary_face_nodes,
                                  m.boundary_face_cells)
    with T.tic("extrude"):
        mesh = pkg.extrude_mesh(m2, z)
    with T.tic("geometry"):
        volume = float(mesh.tpfv_geometry().volumes.sum())
    nc2 = nx * ny
    nc = nc2 * nl
    with T.tic("tags"):
        for k in range(nl):
            pkg.set_mesh_entity_tag(mesh, CELLS, "layers", f"layer{k}",
                                    np.arange(k * nc2, (k + 1) * nc2))
        mean = rng.normal(0.0, 1.0, nl)
        noise = rng.normal(0.0, 0.5, nc)
        perm = np.empty(nc)
        for k in range(nl):
            cells = pkg.get_mesh_entity_tag(mesh, CELLS, "layers",
                                            f"layer{k}")
            perm[cells] = np.exp(mean[k] + noise[cells]) * 0.1 * DARCY
    poro = rng.uniform(0.15, 0.30, nc)
    sw = rng.uniform(0.2, 0.8, nc)
    added = 0
    if fault:
        with T.tic("cut"):
            mesh = pkg.cut_mesh(mesh, pkg.PlaneCut((0.5 * L, 0.5 * L,
                                                    0.5 * H), FAULT_NORMAL))
        # each cut cell's part beyond the plane is a new cell, joined to
        # its parent by one of the cap faces at the end of the face list
        added = mesh.number_of_cells() - nc
        caps = mesh.face_neighbors[mesh.number_of_faces() - added:]
        if not np.array_equal(caps[:, 1], nc + np.arange(added)):
            raise RuntimeError("cut-fault: a cut cell has no cap face")
        with T.tic("geometry"):
            mesh, parent, merged = _merge_slivers(pkg, mesh, caps[:, 0],
                                                  nc)
        added -= merged
        perm, poro, sw = perm[parent], poro[parent], sw[parent]
    geo = mesh.tpfv_geometry()
    cc = geo.cell_centroids
    p0 = (200.0 * BAR - 1000.0 * 9.80665 * cc[:, 2]
          + 2.0 * BAR * np.sin(2 * np.pi * cc[:, 0] / L)
          * np.cos(np.pi * cc[:, 1] / L))
    with T.tic("trajectories"):
        trajs = [np.array([[x * L, y * L, -1.0], [x * L, y * L, H + 1.0]])
                 for x, y in ((0.1, 0.1), (0.9, 0.1), (0.1, 0.9),
                              (0.9, 0.9))]
        # the producer's lateral reach sets its completions, and so the
        # widest row of the generic engine's ELL, which every row pads to
        trajs.append(np.array([[0.495 * L, 0.496 * L, -1.0],
                               [0.499 * L, 0.499 * L, 0.35 * H],
                               [0.502 * L, 0.503 * L, 0.65 * H],
                               [0.505 * L, 0.505 * L, H + 1.0]]))
        well_cells = [pkg.find_enclosing_cells(mesh, t) for t in trajs]
    pv = float(np.sum(poro * geo.volumes))
    q = FLAGSHIP_Q * pv / FLAGSHIP_PV
    specs = [W.WellSpec(name, cells, WI=WELL_WI, volume=1.0)
             for name, cells in zip(WELL_NAMES, well_cells)]
    with T.tic("model"):
        model, wmesh, params = W.setup_well_graph_model(
            mesh, D.ImmiscibleFluid(viscosities=(1e-3, 2e-3)), specs,
            permeability=perm, porosity=poro, gravity=True)
    pw = np.array([p0[c[0]] for c in well_cells])
    sww = np.array([1.0] * 4 + [float(sw[well_cells[-1][0]])])
    state0 = pkg.setup_state(
        model, Pressure=np.concatenate([p0, pw]),
        Saturations=np.stack([np.concatenate([sw, sww]),
                              np.concatenate([1 - sw, 1 - sww])], axis=1))
    forces = {
        "rate": D.PhaseSourceTerm([wmesh.well_cells[f"inj{i}"]
                                   for i in range(4)],
                                  np.array([[q, 0.0]] * 4)),
        "bhp": D.PressureBoundaryCondition(
            [wmesh.well_cells["prod"]], float(pw[-1]) - 2.0 * BAR,
            10.0 * WELL_WI * len(well_cells[-1]), saturations=[0.5, 0.5])}
    return dict(model=model, state0=state0, params=params, forces=forces,
                mesh=mesh, layer_z=z, perm=perm, poro=poro, sw=sw, p0=p0,
                well_cells=well_cells, pw=pw, sww=sww, pore_volume=pv,
                uncut_volume=volume, cells_added=added,
                slivers_merged=merged if fault else 0)


def _merge_slivers(pkg, mesh, cut_parents, nc):
    """A cut mesh with every cut cell whose smaller part holds less than
    SLIVER_FRACTION of its volume made whole again: the part beyond the
    plane takes its parent's id, their cap face goes, the faces the cut
    split stay split (a polyhedral cell may hold two faces to one
    neighbour). A plane through a moved mesh cuts some cells into slivers
    down to 1e-12 of a cell's volume, and at full width those hold the
    ministeps near a minute (PERF.md §6), as simulators keep cells under a
    minimum pore volume out of the flow. Returns (mesh, parent
    cell of each new cell, number merged)."""
    vol = mesh.tpfv_geometry().volumes
    plus = nc + np.arange(len(cut_parents))
    whole = vol[cut_parents] + vol[plus]
    sliver = np.minimum(vol[cut_parents], vol[plus]) < SLIVER_FRACTION * whole
    new_id = np.arange(mesh.number_of_cells())
    new_id[plus[sliver]] = cut_parents[sliver]
    new_id[plus[~sliver]] = nc + np.arange(int((~sliver).sum()))
    nb = new_id[mesh.face_neighbors]
    keep = np.flatnonzero(nb[:, 0] != nb[:, 1])
    fn = mesh.face_nodes
    cnt = fn.counts()[keep]
    within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    faces = pkg.IndirectionMap(
        fn.vals[np.repeat(fn.pos[keep], cnt) + within],
        np.concatenate([[0], np.cumsum(cnt)]))
    out = pkg.UnstructuredMesh(mesh.points, faces, nb[keep],
                               mesh.boundary_face_nodes,
                               new_id[mesh.boundary_face_cells])
    parent = np.concatenate([np.arange(nc), cut_parents[~sliver]])
    return out, parent, int(sliver.sum())


def coarse_reservoir(case, n_blocks, pkg=None):
    """``case`` (a ``layered_reservoir``) on a coarse mesh: its reservoir
    graph partitioned by ``MetisPartitioner`` into ``n_blocks`` blocks with
    each well's completion cells forced into one block, ``CoarseMesh`` +
    ``coarsen_data_domain`` (harmonic permeability, volume-weighted
    porosity: the defaults), the initial pressure and saturation
    volume-weighted; each well completes in its one coarse cell with the
    sum of its fine completions' indices, and keeps its wellbore state and
    controls. The reference's TPFA on the coarse geometry (summed face
    areas, averaged normals and centroids) gives negative half-face
    transmissibilities where a block is not convex or not connected, and
    their harmonic means negative face transmissibilities up to ~200x the
    median, on which Newton does not converge in either package (ROADMAP
    §C): those faces are closed (transmissibility 0), and ``info``
    counts them. Returns (model, state0, params, forces, info)."""
    if pkg is None:
        import jutul.jl_tpu_torch as pkg
    T = _timing(pkg)
    W = importlib.import_module(pkg.__name__ + ".models.wells")
    D = importlib.import_module(pkg.__name__ + ".models.darcy")
    C = importlib.import_module(pkg.__name__ + ".meshes.coarse")
    P = importlib.import_module(pkg.__name__ + ".parallel.partition")
    mesh = case["mesh"]
    nc = mesh.number_of_cells()
    nb = np.asarray(mesh.neighborship())
    with T.tic("partition"):
        part = pkg.MetisPartitioner().partition(
            nb, nc, n_blocks, groups=case["well_cells"])
    vol = mesh.tpfv_geometry().volumes
    dd = pkg.DataDomain(mesh)
    dd.set("permeability", case["perm"])
    dd.set("porosity", case["poro"])
    with T.tic("coarsen"):
        cdd = pkg.coarsen_data_domain(dd, part)
    wells = []
    for cells in case["well_cells"]:
        blocks = np.unique(part[cells])
        if blocks.size != 1:
            raise RuntimeError(f"coarse-upscaled: a well's completions lie "
                               f"in blocks {blocks.tolist()}")
        wells.append(int(blocks[0]))
    specs = [W.WellSpec(name, [c], WI=WELL_WI * len(cells), volume=1.0)
             for name, c, cells in zip(WELL_NAMES, wells,
                                       case["well_cells"])]
    with T.tic("model"):
        model, wmesh, params = W.setup_well_graph_model(
            cdd.mesh, D.ImmiscibleFluid(viscosities=(1e-3, 2e-3)), specs,
            permeability=cdd["permeability"], porosity=cdd["porosity"],
            gravity=True)
    params = dict(params)
    trans = np.asarray(params["Transmissibilities"])
    negative = int(np.sum(trans < 0))
    params["Transmissibilities"] = np.where(trans < 0, 0.0, trans)
    p0 = C.coarsen_cell_value(case["p0"], part, vol, "volume")
    sw = C.coarsen_cell_value(case["sw"], part, vol, "volume")
    pw, sww = case["pw"], case["sww"]
    state0 = pkg.setup_state(
        model, Pressure=np.concatenate([p0, pw]),
        Saturations=np.stack([np.concatenate([sw, sww]),
                              np.concatenate([1 - sw, 1 - sww])], axis=1))
    rate, bhp = case["forces"]["rate"], case["forces"]["bhp"]
    forces = {
        "rate": D.PhaseSourceTerm(
            [wmesh.well_cells[f"inj{i}"] for i in range(4)], rate.values),
        "bhp": D.PressureBoundaryCondition(
            [wmesh.well_cells["prod"]], bhp.pressure, bhp.trans,
            saturations=[0.5, 0.5])}
    cg = cdd.mesh.tpfv_geometry()
    info = dict(partition=part, n_blocks=int(part.max()) + 1,
                load_balance=P.load_balance(part),
                edge_cut=P.edge_cut(part, nb),
                pore_volume=float(np.sum(cdd["porosity"] * cg.volumes)),
                fine_pore_volume=case["pore_volume"], well_blocks=wells,
                negative_transmissibilities=negative,
                faces=int(trans.size))
    return model, state0, params, forces, info


def _layered_run(name, model, state0, params, forces, n_step, setup,
                 extra=None):
    """``Simulator(use_stencil=False)`` on the card in float32 with
    ``generic_config`` (BASELINE.json configuration 3's CPR(AMG +
    ILU(0))-GMRES(20)) over ``n_step`` 6 h report steps of the rate ramp:
    the ELL tables and the AMG hierarchy (native aggregation) built and
    timed first into ``setup``, no kernel may launch, every step must
    succeed, the final state be finite and the last ministep pass the f64
    verify. Returns (sim, res, record)."""
    from jutul.jl_tpu_torch import Simulator, report_stats
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    nc = model.number_of_cells()
    log(f"# {name}: host set-up " + json.dumps(setup))
    t0 = time.perf_counter()
    sim = Simulator(model, state0, params, use_stencil=False)  # the card
    setup["simulator"] = time.perf_counter() - t0
    schedule = rate_schedule(forces, n_step)
    cfg = generic_config()
    t0 = time.perf_counter()
    ell = sim.compiled.ell
    setup["ELL tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hier = cfg["linear_solver"].preconditioner.amg._symbolic(ell)
    setup["AMG hierarchy"] = time.perf_counter() - t0
    log(f"# {name}: ELL slots {ell.n_slots}, simulator, ELL and AMG "
        f"set-up {setup['simulator']:.1f} + {setup['ELL tables']:.1f} + "
        f"{setup['AMG hierarchy']:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.simulate([DT] * n_step, forces=schedule,
                       post_ministep_hook=_progress(name, t0), **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if any(launches.values()):
        raise RuntimeError(f"{name}: a kernel launched: {launches}")
    stats = report_stats(res.reports)
    if not all(r["success"] for r in res.reports) or \
            len(res.reports) != n_step:
        raise RuntimeError(f"{name}: a report step failed")
    for k, v in res.states[-1].items():
        if not np.all(np.isfinite(v)):
            raise RuntimeError(f"{name}: final {k} not finite")
    newtons = stats["newtons"]
    out = {"slice": name, "engine": "generic block-ELL (use_stencil=False)",
           "solver": "GenericKrylov(gmres, CPRPreconditioner(), rtol=1e-3, "
                     "max_iterations=50, restart=20)",
           "cells": nc, "faces": int(model.domain.mesh.number_of_faces()),
           "ell_slots": int(ell.n_slots), "amg_levels": [
               [lv.structure.n_rows, lv.structure.n_slots]
               for lv in hier.levels],
           "dtype": "float32", "report_steps": n_step,
           "ministeps": stats["ministeps"], "newtons": newtons,
           "failed_ministeps": stats["failed_ministeps"],
           "linear_iterations": stats["linear_iterations"], "wall_s": wall,
           "s_per_newton": wall / newtons,
           "cell_newton_its_per_s": nc * newtons / wall,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "host_setup_s": dict(setup),
           **(extra or {}),
           "per_ministep": [[m["iterations"], m["linear_iterations"]]
                            for r_ in res.reports for m in r_["ministeps"]]}
    t0 = time.perf_counter()
    out["f64_verify"] = phase_f64_verify(sim, res, schedule[-1], name)
    out["f64_verify_s"] = time.perf_counter() - t0
    log(f"# {name}: " + json.dumps(out))
    return sim, res, out


def _timed_case(build, *args, **kw):
    """``build(*args, **kw)`` with the port's ``utils/timing`` scopes on:
    (result, {scope: seconds})."""
    from jutul.jl_tpu_torch.utils import timing as T

    T.reset_timings()
    T.set_timing_enabled(True)
    try:
        out = build(*args, **kw)
        times = {k: v["time"] for k, v in T.get_timings().items()}
    finally:
        T.set_timing_enabled(False)
        T.reset_timings()
    return out, times


def phase_extruded_layers(n_step=2):
    """The extruded layered reservoir (``layered_reservoir``) at full width
    through the generic engine (``_layered_run``), its host set-up split
    by ``utils/timing`` scopes; then ``export_mesh_vtu`` of the final
    pressure and water saturation into chiprun_out/ (its bytes and
    seconds; a file above 32 MiB is removed after it is measured, to keep
    that output directory small). Returns (case, record)."""
    from jutul.jl_tpu_torch.utils.vtk import export_mesh_vtu

    case, setup = _timed_case(layered_reservoir, *LAYER_GRID)
    sim, res, out = _layered_run(
        "extruded-layers", case["model"], case["state0"], case["params"],
        case["forces"], n_step, setup,
        extra={"grid": list(LAYER_GRID), "completions": [
            len(c) for c in case["well_cells"]],
            "pore_volume_m3": case["pore_volume"]})
    nc = case["mesh"].number_of_cells()
    final = res.states[-1]
    os.makedirs("chiprun_out", exist_ok=True)
    t0 = time.perf_counter()
    fn = export_mesh_vtu("chiprun_out/extruded-layers.vtu", case["mesh"], {
        "Pressure": final["Pressure"][:nc],
        "Sw": final["Saturations"][:nc, 0]})
    out["vtu"] = {"seconds": time.perf_counter() - t0,
                  "bytes": os.path.getsize(fn)}
    if out["vtu"]["bytes"] > 32 * 2 ** 20:
        os.remove(fn)
        out["vtu"]["kept"] = False
    log("# extruded-layers vtu: " + json.dumps(out["vtu"]))
    del sim, res
    torch.cuda.empty_cache()
    return case, out


def phase_coarse_upscaled(case, n_step=2):
    """``case`` partitioned and coarsened (``coarse_reservoir``) through
    the generic engine as ``extruded-layers``; the coarse pore volume must
    equal the fine one within 1e-12 relative."""
    (model, state0, params, forces, info), setup = _timed_case(
        coarse_reservoir, case, COARSE_BLOCKS)
    rel = abs(info["pore_volume"] / info["fine_pore_volume"] - 1.0)
    if not rel <= 1e-12:
        raise RuntimeError(f"coarse-upscaled: pore volume {rel:.3e} apart")
    sim, res, out = _layered_run(
        "coarse-upscaled", model, state0, params, forces, n_step, setup,
        extra={"blocks": info["n_blocks"],
               "load_balance": info["load_balance"],
               "edge_cut": info["edge_cut"],
               "pore_volume_rel_err": rel,
               "closed_negative_transmissibilities":
                   info["negative_transmissibilities"]})
    del sim, res
    torch.cuda.empty_cache()
    return out


def phase_cut_fault(n_step=2, grid=None):
    """``layered_reservoir(fault=True)``: the extruded reservoir cut by one
    dipping plane through its centre, at ``grid`` if the cut builds within
    CUT_GRID_LIMIT_S there, else at CUT_GRID_REDUCED; its total volume must
    equal the uncut one within 1e-12 relative; then the run of
    ``extruded-layers``."""
    grid = grid or LAYER_GRID
    case, setup = _timed_case(layered_reservoir, *grid, fault=True)
    log(f"# cut-fault at {grid}: the cut {setup['cut']:.1f} s, "
        f"{case['cells_added']} cells added")
    if setup["cut"] > CUT_GRID_LIMIT_S and grid != CUT_GRID_REDUCED:
        log(f"# cut-fault: the cut took {setup['cut']:.1f} s at {grid}")
        return phase_cut_fault(n_step, CUT_GRID_REDUCED)
    vol = float(case["mesh"].tpfv_geometry().volumes.sum())
    rel = abs(vol / case["uncut_volume"] - 1.0)
    if not rel <= 1e-12:
        raise RuntimeError(f"cut-fault: volume {rel:.3e} from the uncut one")
    sim, res, out = _layered_run(
        "cut-fault", case["model"], case["state0"], case["params"],
        case["forces"], n_step, setup,
        extra={"grid": list(grid), "cut_s": setup["cut"],
               "cells_added": case["cells_added"], "volume_rel_err": rel,
               "completions": [len(c) for c in case["well_cells"]]})
    del sim, res
    torch.cuda.empty_cache()
    return out


def phase_meshes_cross_check(dims=LAYER_SMALL):
    """``layered_reservoir`` at ``dims`` in float64, 2 report steps, on the
    card twice and on the CPU: equal ministep, Newton and linear-iteration
    counts, states within 1e-12, the two card runs bit for bit."""
    from jutul.jl_tpu_torch import Simulator

    c = layered_reservoir(*dims)
    model, state0, params, forces = (c[k] for k in (
        "model", "state0", "params", "forces"))
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        sim = Simulator(model, state0, params, use_stencil=False,
                        device=dev, dtype=torch.float64)
        res = sim.simulate([DT] * 2, forces=rate_schedule(forces, 2),
                           **generic_config())
        runs.append((res, [(m["iterations"], m["linear_iterations"],
                            m["success"]) for r in res.reports
                           for m in r["ministeps"]]))
    (ga, ca), (gb, cb), (cpu, cc) = runs
    if not (ca == cb == cc):
        raise RuntimeError(f"meshes cross-check: counts differ: card {ca}, "
                           f"{cb}, CPU {cc}")
    bitwise = all(np.array_equal(x[k], y[k]) for x, y in zip(
        ga.states, gb.states) for k in x)
    dev = max(float(np.max(np.abs(x[k] - y[k]) / np.maximum(
        np.abs(y[k]), 1.0 if k == "Saturations" else 1e-300)))
        for x, y in zip(ga.states, cpu.states)
        for k in ("Pressure", "Saturations"))
    out = {"dims": list(dims), "ministeps": len(cc),
           "newtons": sum(m[0] for m in cc),
           "linear_iterations": sum(m[1] for m in cc),
           "max_rel_dev_card_cpu": dev, "card_runs_bitwise": bitwise}
    log("# meshes cross-check card vs CPU (f64): " + json.dumps(out))
    if not (bitwise and dev <= 1e-12):
        raise RuntimeError(f"meshes cross-check: {out}")
    return out


def meshes_phases(n_step=2):
    """The meshes slice's phases: extruded-layers, coarse-upscaled,
    cut-fault and the cross-check. Returns their records by name."""
    out = {}
    case, out["extruded-layers"] = phase_extruded_layers(n_step)
    out["coarse-upscaled"] = phase_coarse_upscaled(case, n_step)
    del case
    out["cut-fault"] = phase_cut_fault(n_step)
    out["meshes-cross-check"] = phase_meshes_cross_check()
    return out


def transport_phases(n_step=3, nx=None, amp=0.0):
    """The transport slice's phases at TRANSPORT_GRID (or nx x nx) on one
    quad UnstructuredMesh (its interior nodes moved by ``amp`` h, default
    none: phase_stencil_conditioning says why): WENO transport (with its
    fused-body system and engine check) and NFVM pressure; then the
    stencil-conditioning check, the cross-check and the helpers. Returns
    their records by name."""
    global TRANSPORT_GRID
    if nx:
        TRANSPORT_GRID = (nx, nx)
    out = {}
    mesh, setup = build_transport_mesh(*TRANSPORT_GRID, amp=amp)
    sim, res, out["weno-transport"], state0 = phase_weno_transport(
        mesh, setup, n_step=n_step)
    out["weno-transport-fused"] = phase_weno_transport_fused(sim, state0)
    out["weno-engine-check"] = phase_weno_engine_check(sim, res, state0)
    del sim, res
    torch.cuda.empty_cache()
    out["nfvm-pressure"] = phase_nfvm_pressure(mesh, setup)
    del mesh
    out["stencil-conditioning"] = phase_stencil_conditioning()
    out["transport-cross-check"] = phase_transport_cross_check()
    out["helpers-on-card"] = phase_helpers_on_card()
    return out


# ---------------------------------------------------------------------------
# the distributed engines (parallel/): shard groups, slab and general
# partitions, their CPR and adjoints
# ---------------------------------------------------------------------------
DD_SHARDS = 8  # the JAX package's fake-device count (tests/conftest.py)
DRYRUN_GRID = (6, 5, 4)  # __graft_entry__.py dryrun_multichip
SLAB_CROSS_GRID = (4, 3, 8)  # tests/test_sharded.py build_case
DD_BAR = 1e-6  # dryrun_multichip's equivalence bars (states, gradients)
DD_SLAB_REPORTS = 1  # srcwells' report steps that dd-slab runs again
# dd-slab's final state against srcwells' (both float32, each ministep
# accepted at CNV 1e-3, or 1e-2 at the Newton cap): a few times the spread
# of two single-device float32 solver settings on the well flagship (the
# A/B phase: 1.3e-4 pressure, 0.014 saturation)
DD_SLAB_P_BAR, DD_SLAB_S_BAR = 1e-3, 0.05
# dd-general's float64 adjoint: λ-solves at bench.py run_adjoint's rtol with
# a cap the block-Jacobi solves of 1,048,581 cells reach; the gradients
# against the single-device adjoint's of the same states
DD_LAMBDA_RTOL, DD_LAMBDA_ITS, DD_LAMBDA_GRAD_BAR = 1e-6, 4000, 1e-3
# MULTICHIP_r05.json's measurement of those bars (JAX package, 8 fake
# devices): max|dP|/|P| and max rel |dGrad| of the dryrun case
MULTICHIP_R05 = {"states": 4.19e-16, "gradients": 5.68e-11}
# the global GMG V-cycle: K10 on the fine and mid levels, K8 the coarse
# solve
SLICE_KERNELS["dd-slab"] = (K10, K8)
SLICE_FORBIDDEN["dd-slab"] = tuple(k for k in KERNEL_INFO
                                   if k not in (K10, K8))
# the general engine assembles and solves in face-block form: no kernel
SLICE_KERNELS["dd-general"] = ()
SLICE_FORBIDDEN["dd-general"] = tuple(KERNEL_INFO)
# the distributed MultiModel: face-block SpMV, block-Jacobi and a dense LU
# of the replicated wells, as the JAX package's: no kernel
SLICE_KERNELS["dd-multimodel"] = ()
SLICE_FORBIDDEN["dd-multimodel"] = tuple(KERNEL_INFO)
# dd-multimodel's BiCGStab cap per Newton (block-Jacobi under EW forcing)
# and its adjoint's depth: the first accepted ministep (a depth cut from
# 2, for the script's time: its f64 block-Jacobi λ-solves take thousands
# of iterations on the card)
DD_MM_LIN_ITS = 200
DD_MM_ADJOINT_STEPS = 1
# dd-multimodel's depth: the first of the 6 accepted ministeps of
# wells-multimodel's first report step (a depth cut, for the script's
# time: all 6 took 129-178 s, 34 Newtons, on an H100 80GB HBM3 at 700 W)
DD_MM_MINISTEPS = 1
# its λ-solves' rtol: the f64 block-Jacobi λ-solve of one ministep took
# 1,999-2,516 iterations (124-160 s on that card) at dd-general's 1e-6,
# where the pressure objective's gradients agree with the well-graph
# form's to 2e-10, far inside the 1e-3 bar
DD_MM_LAMBDA_RTOL = 1e-4


def dryrun_case(pkg, n_shards, dims=DRYRUN_GRID):
    """``dryrun_multichip``'s case (__graft_entry__.py:174-290) through
    ``pkg``'s API: a 6x5x4 ``UnstructuredMesh`` with gravity, lognormal
    permeability and 2 well models on the augmented well graph, forced
    well groups in a ``GreedyGraphPartitioner`` partition over
    ``n_shards``, a rate injector and a BHP producer, two steps of 0.1 and
    0.2 days at tolerance 1e-10. Returns a dict (host numpy)."""
    um = importlib.import_module(pkg.__name__ + ".meshes.unstructured")
    dm = importlib.import_module(pkg.__name__ + ".models.darcy")
    wm = importlib.import_module(pkg.__name__ + ".models.wells")
    pm = importlib.import_module(pkg.__name__ + ".parallel.partition")
    BAR, DARCY, DAY = pkg.si_units("bar", "darcy", "day")
    nx, ny, nz = dims
    base = um.UnstructuredMesh.from_cartesian(
        pkg.CartesianMesh((nx, ny, nz), (60.0, 50.0, 20.0)))
    nc = base.number_of_cells()
    rng = np.random.default_rng(0)
    perm = rng.lognormal(0.0, 1.0, nc) * 0.2 * DARCY
    poro = np.full(nc, 0.25)

    def cell(ix, iy, iz):
        return (iz * ny + iy) * nx + ix

    wells = [wm.WellSpec("inj", [cell(0, 0, 0), cell(0, 0, 1)],
                         WI=[2e-12, 3e-12], volume=0.5),
             wm.WellSpec("prod", [cell(nx - 1, ny - 1, nz - 1)], WI=4e-12,
                         volume=0.5)]
    model, wmesh, params = wm.setup_well_graph_model(
        base, dm.ImmiscibleFluid(viscosities=(1e-3, 2e-3)), wells,
        permeability=perm, porosity=poro, gravity=True)
    forces = {
        "rate": dm.PhaseSourceTerm([wmesh.well_cells["inj"]],
                                   np.array([[0.05, 0.0]])),
        "bhp": dm.PressureBoundaryCondition([wmesh.well_cells["prod"]],
                                            120.0 * BAR, 1e-11,
                                            saturations=[0.5, 0.5])}
    groups = wmesh.partition_groups()
    part = pm.GreedyGraphPartitioner().partition(
        wmesh.neighborship(), wmesh.number_of_cells(), n_shards,
        groups=groups)
    state0 = pkg.setup_state(model, Pressure=np.full(
        wmesh.number_of_cells(), 150.0 * BAR), Saturations=np.tile(
            [0.3, 0.7], (wmesh.number_of_cells(), 1)))
    return dict(model=model, wmesh=wmesh, params=params, forces=forces,
                groups=groups, part=part, state0=state0, p_ref=150.0 * BAR,
                data_fields={"permeability": np.concatenate(
                    [perm, np.full(len(wells), perm.mean())]),
                    "porosity": np.concatenate([poro, np.ones(len(wells))])},
                dts=[0.1 * DAY, 0.2 * DAY], tols={"default": 1e-10})


def slab_case(pkg, dims=SLAB_CROSS_GRID, smooth=False):
    """tests/test_sharded.py ``build_case`` through ``pkg``: a Cartesian
    two-phase model without gravity, seeded uniform permeability and
    initial state; ``smooth``: constant permeability and a uniform start
    (the adjoint tests' well-conditioned variant). One water injector.
    Returns (mesh, system, data_fields, state0 kwargs, forces)."""
    dm = importlib.import_module(pkg.__name__ + ".models.darcy")
    BAR, DARCY = pkg.si_units("bar", "darcy")
    nx, ny, nz = dims
    nc = nx * ny * nz
    mesh = pkg.CartesianMesh((nx, ny, nz), (10.0, 10.0, 10.0))
    system = dm.ImmiscibleSystem(dm.ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
                                 gravity=False)
    rng = np.random.default_rng(0)
    perm = rng.uniform(0.5, 2.0, nc) * DARCY
    p0 = 100.0 * BAR + rng.uniform(-1, 1, nc) * BAR
    sw = rng.uniform(0.2, 0.8, nc)
    if smooth:
        perm, p0, sw = np.full(nc, DARCY), np.full(nc, 100.0 * BAR), \
            np.full(nc, 0.3)
    q = np.zeros((1, 2))
    q[0, 0] = 0.5
    return (mesh, system, {"permeability": perm,
                           "porosity": np.full(nc, 0.25)},
            dict(Pressure=p0, Saturations=np.stack([sw, 1 - sw], axis=1)),
            {"src": dm.PhaseSourceTerm([0], q)})


def unstructured_dd_case(pkg, dims=DRYRUN_GRID, seed=0):
    """tests/test_general_dd.py ``build_unstructured_case`` through
    ``pkg``: the dryrun mesh without wells, gravity on, seeded lognormal
    permeability and initial state. Returns (mesh, system, data_fields,
    state0 kwargs)."""
    um = importlib.import_module(pkg.__name__ + ".meshes.unstructured")
    dm = importlib.import_module(pkg.__name__ + ".models.darcy")
    BAR, DARCY = pkg.si_units("bar", "darcy")
    mesh = um.UnstructuredMesh.from_cartesian(
        pkg.CartesianMesh(dims, (60.0, 50.0, 20.0)))
    nc = mesh.number_of_cells()
    rng = np.random.default_rng(seed)
    perm = rng.lognormal(0.0, 1.0, nc) * 0.2 * DARCY
    p0 = 150.0 * BAR + rng.uniform(-0.5, 0.5, nc) * BAR
    sw = rng.uniform(0.25, 0.75, nc)
    system = dm.ImmiscibleSystem(dm.ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
                                 gravity=True)
    return (mesh, system, {"permeability": perm,
                           "porosity": np.full(nc, 0.25)},
            dict(Pressure=p0, Saturations=np.stack([sw, 1 - sw], axis=1)))


def coupled_dd_case(pkg, dims=DRYRUN_GRID, seed=0, fault=False,
                    schur=False):
    """tests/test_distributed_multimodel.py's ``_coupled_case`` through
    ``pkg``'s API: the dryrun mesh (an ``UnstructuredMesh`` of ``dims``,
    gravity, seeded lognormal permeability) as the reservoir of a
    MultiModel with 2 one-cell well models (``setup_well_multimodel``: a
    two-completion rate injector, a BHP producer). ``fault``:
    dryrun_multichip's leaky fault, a ``DarcyTransferCrossTerm`` inside the
    reservoir between cells [1, 4] and [nc - 2, nc - 5]
    (__graft_entry__.py:308-311); ``schur``: ``reduction="schur_apply"``.
    Returns a dict (host numpy): mm, names, state0, forces, the dryrun's
    two steps of 0.1 and 0.2 days and tolerance 1e-10."""
    um = importlib.import_module(pkg.__name__ + ".meshes.unstructured")
    dm = importlib.import_module(pkg.__name__ + ".models.darcy")
    wm = importlib.import_module(pkg.__name__ + ".models.wells")
    BAR, DARCY, DAY = pkg.si_units("bar", "darcy", "day")
    nx, ny, nz = dims
    mesh = um.UnstructuredMesh.from_cartesian(
        pkg.CartesianMesh((nx, ny, nz), (60.0, 50.0, 20.0)))
    nc = mesh.number_of_cells()
    rng = np.random.default_rng(seed)
    fluid = dm.ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    perm = rng.lognormal(0.0, 1.0, nc) * 0.2 * DARCY
    res = dm.setup_darcy_model(mesh, fluid, permeability=perm,
                               porosity=0.25, gravity=True)

    def cell(ix, iy, iz):
        return (iz * ny + iy) * nx + ix

    wells = [wm.WellSpec("inj", [cell(0, 0, nz - 1), cell(0, 0, nz - 2)],
                         WI=[2e-12, 3e-12], volume=0.5),
             wm.WellSpec("prod", [cell(nx - 1, ny - 1, 0)], WI=4e-12,
                         volume=0.5)]
    mm, names = wm.setup_well_multimodel(res, wells, fluid=fluid)
    if fault:
        mm.add_cross_term(dm.DarcyTransferCrossTerm([3e-13, 2e-13]),
                          target="reservoir", source="reservoir",
                          equation="mass_conservation", target_cells=[1, 4],
                          source_cells=[nc - 2, nc - 5])
    if schur:
        mm.reduction = "schur_apply"
    p0, sw0 = 150.0 * BAR, 0.4
    state0 = {"reservoir": pkg.setup_state(res, Pressure=p0,
                                           Saturations=[sw0, 1 - sw0]),
              **{n: pkg.setup_state(mm[n], Pressure=p0,
                                    Saturations=[sw0, 1 - sw0])
                 for n in names}}
    forces = {
        "reservoir": None,
        "inj": {"rate": dm.PhaseSourceTerm([0], np.array([[0.05, 0.0]]))},
        "prod": {"bhp": dm.PressureBoundaryCondition(
            [0], 120.0 * BAR, 1e-11, saturations=[0.5, 0.5])}}
    return dict(mm=mm, names=list(names), state0=state0, forces=forces,
                nc=nc, p_ref=150.0 * BAR, dts=[0.1 * DAY, 0.2 * DAY],
                adjoint_dts=[0.05 * DAY, 0.08 * DAY],
                tols={"default": 1e-10})


def coupled_objective(names, p_ref):
    """dryrun_multichip's MultiModel objective: G = sum_n dt_n (sum over
    the reservoir's and every well's cells of (p / p_ref)^2)."""
    def G(mm, state, dt, n, forces):
        tot = dt * torch.sum((state["reservoir"]["Pressure"] / p_ref) ** 2)
        for w in names:
            tot = tot + dt * torch.sum((state[w]["Pressure"] / p_ref) ** 2)
        return tot
    return G


def replica_mismatches(dmm, shards):
    """The replicated small-model entries (``"model.variable"``) of a
    distributed MultiModel's per-shard states that differ from shard 0's
    in any bit."""
    return [f"{n}.{k}" for n in dmm.small_names for k in shards[0][n]
            if not all(torch.equal(shards[0][n][k], s[n][k])
                       for s in shards[1:])]


def watch_replicas(dmm):
    """Hold ``dmm``'s replicated states to each other after every
    ministep: wraps its ministep and returns the list it appends to (one
    list of ``replica_mismatches`` per ministep, empty when every shard
    holds the same bits)."""
    seen = []
    inner = dmm._ministep

    def ministep(*args, **kw):
        out = inner(*args, **kw)
        seen.append(replica_mismatches(dmm, out[1]))
        return out

    dmm._ministep = ministep
    return seen


def pressure_objective(p_ref):
    """dryrun_multichip's objective: G = sum_n dt_n sum((p / p_ref)^2)."""
    def G(model, state, dt, n, forces):
        return dt * torch.sum((state["Pressure"] / p_ref) ** 2)
    return G


def _state_rel(a, b):
    """max over the fields of ``a`` of max|a - b| / max|b|."""
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k])))
                   / max(float(np.max(np.abs(np.asarray(b[k])))), 1e-300))
               for k in a if k in b and k != "substates")


def _grad_rel(g, ref):
    return max(float(np.max(np.abs(np.asarray(g[k]).reshape(
        np.shape(ref[k])) - ref[k])) / max(float(np.max(np.abs(ref[k]))),
                                           1e-30)) for k in ref)


def _dryrun_run(c, group, part, dtype=torch.float64):
    """The dryrun case through ``GeneralDistributedSimulator`` on
    ``group``: distributed CPR with Chebyshev smoothing, ppermute halos."""
    from jutul.jl_tpu_torch import GeneralDistributedSimulator

    dsim = GeneralDistributedSimulator(
        c["wmesh"], c["model"].system, group, partition=part,
        parameters=c["params"], data_fields=c["data_fields"],
        halo_mode="ppermute", dtype=dtype)
    states, reports = dsim.simulate(
        c["state0"], c["dts"], forces=c["forces"], tolerances=c["tols"],
        max_newton=40, preconditioner="cpr", cpr_smoother="chebyshev",
        info_level=-1)
    return dsim, states, reports


def _counts(reports):
    return [[m["iterations"], m["linear_iterations"]]
            for r in reports for m in r["ministeps"]]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dd_mm_run(c, group, part, dtype=torch.float64):
    """``coupled_dd_case``'s case through ``GeneralDistributedMultiModel``
    on ``group``; the replicated wells watched after every ministep."""
    from jutul.jl_tpu_torch.parallel.multimodel import (
        GeneralDistributedMultiModel,
    )

    dmm = GeneralDistributedMultiModel(c["mm"], group, main="reservoir",
                                       partition=part, dtype=dtype)
    seen = watch_replicas(dmm)
    states, reports = dmm.simulate(
        c["state0"], c["dts"], forces=c["forces"], tolerances=c["tols"],
        max_newton=40, rtol=1e-12, max_lin_it=500, info_level=-1)
    return dmm, states, reports, seen


def _mm_rel(a, b):
    """``_state_rel`` over every submodel of two MultiModel states."""
    return max(_state_rel(a[m], b[m]) for m in b)


def _mm_grad_rel(g, ref):
    """The largest relative gradient gap over every submodel's non-empty
    parameters, each against its own largest entry."""
    return max(_grad_rel({k: g[m][k]}, {k: np.asarray(v)})
               for m, grads in ref.items() for k, v in grads.items()
               if np.asarray(v).size)


def dd_cross_check_multimodel(device="cuda"):
    """dryrun_multichip's distributed MultiModel (__graft_entry__.py:
    288-389; ``coupled_dd_case(fault=True, schur=True)``: 2 replicated well
    models, the leaky fault inside the reservoir, the wells Schur-eliminated)
    in float64 over ``ShardGroup.threads(8)`` on the card against
    ``Simulator(mm)``, then ``solve_adjoint_sensitivities_multimodel_general``
    over two one-ministep steps against ``solve_adjoint_sensitivities`` on
    the same single-device states; the same distributed run on the CPU; the
    replicated well states bit for bit across the shards after every
    ministep. Returns (record, case, partition) for the one-rank check."""
    import jutul.jl_tpu_torch as tp
    from jutul.jl_tpu_torch.parallel.multimodel_adjoint import (
        solve_adjoint_sensitivities_multimodel_general,
    )

    f64 = torch.float64
    t0 = time.perf_counter()
    c = coupled_dd_case(tp, fault=True, schur=True)
    mesh = c["mm"]["reservoir"].domain.mesh
    part = tp.GreedyGraphPartitioner().partition(mesh.neighborship(),
                                                 c["nc"], DD_SHARDS)
    dmm, sd, reps, seen = _dd_mm_run(
        c, tp.ShardGroup.threads(DD_SHARDS, device), part)
    ref = tp.Simulator(c["mm"], c["state0"], device=device,
                       dtype=f64).simulate(
        c["dts"], forces=c["forces"], info_level=-1, tolerances=c["tols"],
        max_nonlinear_iterations=40)
    out = {"cells": c["nc"] + len(c["names"]), "shards": DD_SHARDS,
           "internal_pairs": len(dmm.internal_pairs), "schur": dmm.schur,
           "counts": _counts(reps),
           "states_rel": _mm_rel(sd[-1], ref.states[-1]),
           "replicas_bitwise": not any(seen),
           "ministeps_watched": len(seen)}
    fwd = tp.Simulator(c["mm"], c["state0"], device=device,
                       dtype=f64).simulate(
        c["adjoint_dts"], forces=c["forces"], info_level=-1,
        tolerances=c["tols"], max_nonlinear_iterations=40)
    if tp.report_stats(fwd.reports)["ministeps"] != len(c["adjoint_dts"]):
        raise RuntimeError("dd-cross-check (multimodel): the adjoint's "
                           "forward took more than one ministep per step")
    G = coupled_objective(c["names"], c["p_ref"])
    g_ref = tp.solve_adjoint_sensitivities(
        c["mm"], fwd.states, c["adjoint_dts"], G,
        parameters=tp.setup_parameters(c["mm"]), state0=c["state0"],
        forces=c["forces"], device=device, dtype=f64)
    g_dist = solve_adjoint_sensitivities_multimodel_general(
        dmm, fwd.states, c["adjoint_dts"], G, c["state0"],
        forces=c["forces"], reports=fwd.reports, rtol=1e-13,
        max_lin_it=2000)
    out["gradients_rel"] = _mm_grad_rel(g_dist, g_ref)
    _d, s_cpu, r_cpu, seen_cpu = _dd_mm_run(
        c, tp.ShardGroup.threads(DD_SHARDS, "cpu"), part)
    out["card_vs_cpu_rel"] = _mm_rel(sd[-1], s_cpu[-1])
    out["cpu_counts"] = _counts(r_cpu)
    out["cpu_replicas_bitwise"] = not any(seen_cpu)
    out["seconds"] = time.perf_counter() - t0
    return out, c


def phase_dd_cross_check(device="cuda"):
    """The distributed engines in float64 against the port's single-device
    engine, within dryrun_multichip's bars (states and gradients 1e-6,
    beside MULTICHIP_r05.json's measurement of the JAX package):
    - the dryrun case over ``ShardGroup.threads(8)`` on the card through
      ``GeneralDistributedSimulator`` (distributed CPR, Chebyshev, ppermute
      halos) against ``Simulator``, then
      ``solve_adjoint_sensitivities_general`` against
      ``solve_adjoint_sensitivities`` on the single-device states; the
      same distributed run on the CPU within 1e-12 of the card's; a
      world-size-1 NCCL ``ShardGroup.process_group`` run equal to
      ``threads(1)`` bit for bit;
    - tests/test_sharded.py's case on 4 slabs with the slab engine's
      distributed CPR against ``Simulator``, then the slab adjoint against
      the single-device one (its smooth variant);
    - the dryrun's MultiModel form (``dd_cross_check_multimodel``), its
      one-rank NCCL run equal to ``threads(1)`` bit for bit."""
    import jutul.jl_tpu_torch as tp

    f64 = torch.float64
    out = {"bars": {"states": DD_BAR, "gradients": DD_BAR},
           "multichip_r05": MULTICHIP_R05}
    t0 = time.perf_counter()
    c = dryrun_case(tp, DD_SHARDS)
    dsim, sd, reps = _dryrun_run(c, tp.ShardGroup.threads(DD_SHARDS, device),
                                 c["part"])
    sim = tp.Simulator(c["model"], c["state0"], c["params"], device=device,
                       dtype=f64)
    ref = sim.simulate(c["dts"], forces=c["forces"], info_level=-1,
                       tolerances=c["tols"], max_nonlinear_iterations=40)
    sr = ref.states
    out["dryrun"] = {
        "cells": int(c["wmesh"].number_of_cells()), "shards": DD_SHARDS,
        "counts": _counts(reps),
        "states_rel": _state_rel(sd[-1], sr[-1]),
        "pressure_rel": _state_rel({"p": sd[-1]["Pressure"]},
                                   {"p": sr[-1]["Pressure"]}),
        "saturation_abs": float(np.max(np.abs(
            sd[-1]["Saturations"] - sr[-1]["Saturations"])))}
    G = pressure_objective(c["p_ref"])
    g_ref = tp.solve_adjoint_sensitivities(
        c["model"], [dict(s) for s in sr], c["dts"], G,
        parameters=c["params"], state0=c["state0"], forces=c["forces"],
        device=device, dtype=f64)
    g_dist = tp.solve_adjoint_sensitivities_general(
        dsim, [dict(s) for s in sr], c["dts"], G, c["state0"],
        forces=c["forces"], parameters=c["params"], rtol=1e-13,
        max_lin_it=2000)
    out["dryrun"]["gradients_rel"] = _grad_rel(g_dist, g_ref)
    _d, s_cpu, reps_cpu = _dryrun_run(c, tp.ShardGroup.threads(DD_SHARDS,
                                                                "cpu"),
                                      c["part"])
    out["dryrun"]["card_vs_cpu_rel"] = _state_rel(sd[-1], s_cpu[-1])
    out["dryrun"]["cpu_counts"] = _counts(reps_cpu)
    out["multimodel"], cm = dd_cross_check_multimodel(device)
    # one rank of NCCL against one thread: the same bits, for the general
    # engine and the distributed MultiModel
    import torch.distributed as dist

    one = np.zeros(c["wmesh"].number_of_cells(), dtype=np.int64)
    one_m = np.zeros(cm["nc"], dtype=np.int64)
    _d, s_th1, _r = _dryrun_run(c, tp.ShardGroup.threads(1, device), one)
    _d, m_th1, _r, _s = _dd_mm_run(cm, tp.ShardGroup.threads(1, device),
                                   one_m)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        _d, s_pg1, _r = _dryrun_run(c, tp.ShardGroup.process_group(), one)
        _d, m_pg1, _r, _s = _dd_mm_run(cm, tp.ShardGroup.process_group(),
                                       one_m)
    finally:
        dist.destroy_process_group()
    out["dryrun"]["nccl1_equals_threads1"] = all(
        np.array_equal(s_pg1[-1][k], s_th1[-1][k]) for k in s_th1[-1])
    out["multimodel"]["nccl1_equals_threads1"] = all(
        np.array_equal(m_pg1[-1][m][k], m_th1[-1][m][k])
        for m in m_th1[-1] for k in m_th1[-1][m])
    out["dryrun"]["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh, system, df, init, forces = slab_case(tp)
    slab = tp.DistributedSimulator(mesh, system, tp.ShardGroup.threads(
        4, device), data_fields=df, local_preconditioner="cpr", dtype=f64)
    st0 = slab.initial_state(**init)
    DAY = tp.si_unit("day")
    ss, sreps = slab.simulate(st0, [0.05 * DAY], forces=forces,
                              tol_cnv=1e-10, max_newton=30, info_level=-1)
    sref = tp.Simulator(slab.global_model, st0, device=device,
                        dtype=f64).simulate(
        [0.05 * DAY], forces=forces, info_level=-1,
        tolerances={"default": 1e-10}, max_nonlinear_iterations=30)
    mesh, system, df, init, forces = slab_case(tp, smooth=True)
    smooth = tp.DistributedSimulator(mesh, system, tp.ShardGroup.threads(
        4, device), data_fields=df, dtype=f64)
    st0s = smooth.initial_state(**init)
    params = tp.setup_parameters(smooth.global_model)
    dts = [0.05 * DAY, 0.05 * DAY]
    ref_s = tp.Simulator(smooth.global_model, st0s, params, device=device,
                         dtype=f64).simulate(
        dts, forces=forces, info_level=-1, tolerances={"default": 1e-10},
        max_nonlinear_iterations=30).states
    Gs = pressure_objective(100.0 * tp.si_unit("bar"))
    gs_ref = tp.solve_adjoint_sensitivities(
        smooth.global_model, [dict(s) for s in ref_s], dts, Gs,
        parameters=params, state0=st0s, forces=forces, device=device,
        dtype=f64)
    gs = tp.solve_adjoint_sensitivities_distributed(
        smooth, [dict(s) for s in ref_s], dts, Gs, st0s, forces=forces,
        parameters=params, rtol=1e-13, max_lin_it=2000)
    out["slab"] = {"cells": int(mesh.number_of_cells()), "shards": 4,
                   "counts": _counts(sreps),
                   "states_rel": _state_rel(ss[-1], sref.states[-1]),
                   "gradients_rel": _grad_rel(gs, gs_ref),
                   "seconds": time.perf_counter() - t0}
    log("# dd-cross-check: " + json.dumps(out))
    d, s, m = out["dryrun"], out["slab"], out["multimodel"]
    if not all(x["states_rel"] < DD_BAR and x["gradients_rel"] < DD_BAR
               for x in (d, s, m)):
        raise RuntimeError(f"dd-cross-check: beyond the bars: {out}")
    if not (d["card_vs_cpu_rel"] <= 1e-12 and m["card_vs_cpu_rel"] <= 1e-12):
        raise RuntimeError(f"dd-cross-check: card and CPU differ: {out}")
    if not (d["nccl1_equals_threads1"] and m["nccl1_equals_threads1"]):
        raise RuntimeError("dd-cross-check: the NCCL rank differs from the "
                           "thread")
    if not (m["replicas_bitwise"] and m["cpu_replicas_bitwise"]):
        raise RuntimeError("dd-cross-check: the replicated well states "
                           "differ between shards")
    return out


def dd_f64_verify(model, params, state, state0, dt, forces, name,
                  device="cuda"):
    """The final accepted ministep of a distributed run, gathered to the
    global state, re-assembled in float64 on the card by the single-device
    generic engine: CNV and MB within 10x their tolerances."""
    from jutul.jl_tpu_torch import compile_model, from_numpy

    comp = compile_model(model)
    pr = from_numpy(params, device, torch.float64)
    s = {**from_numpy(state, device, torch.float64), **pr}
    s0 = {**from_numpy(state0, device, torch.float64), **pr}
    r, _, full = comp.assemble(s, s0, dt, forces, with_jacobian=False)
    c = comp.convergence(r, full, dt)["mass_conservation"]
    out = {"rows": int(r.shape[0]),
           "f64_max_abs_residual": float(r.abs().max()),
           "f64_CNV": float(c["CNV"].max()), "f64_MB": float(c["MB"].max())}
    log(f"# {name} f64 verify: " + json.dumps(out))
    if not (out["f64_CNV"] <= 10 * CNV_TOL and out["f64_MB"] <= 10 * MB_TOL):
        raise RuntimeError(f"{name} f64 verify: residual out of bound: {out}")
    return out


def dd_config():
    """The Newton settings of the distributed runs: srcwells' tolerances,
    Newton cap and final-iteration factor, BiCGStab at rtol 1e-3."""
    return dict(tolerances={"mass_conservation/CNV": CNV_TOL,
                            "mass_conservation/MB": MB_TOL},
                max_newton=12, tol_factor_final_iteration=10.0, rtol=1e-3)


def _dd_record(name, dsim, states, reports, wall, launches, setup, nc,
               n_step):
    from jutul.jl_tpu_torch import report_stats

    stats = report_stats(reports)
    if len(reports) != n_step or not all(r["success"] for r in reports):
        raise RuntimeError(f"{name}: a report step failed")
    for k, v in states[-1].items():
        if k != "substates" and not np.all(np.isfinite(v)):
            raise RuntimeError(f"{name}: final {k} not finite")
    if dsim.device.type == "cuda":  # CPU tensors run the plain versions
        _check_launches(name, name, launches)
    newtons, lin = stats["newtons"], stats["linear_iterations"]
    return {"slice": name, "cells": nc, "shards": dsim.n_devices,
            "dtype": str(dsim.dtype).replace("torch.", ""),
            "report_steps": n_step,
            "ministeps": stats["ministeps"], "newtons": newtons,
            "failed_ministeps": stats["failed_ministeps"],
            "linear_iterations": lin, "wall_s": wall,
            "s_per_newton": wall / newtons,
            "cell_newton_its_per_s": nc * newtons / wall,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                               if dsim.device.type == "cuda" else None),
            "host_setup_s": setup, "launches": launches,
            "launches_per_linear_iteration": {
                k: v / max(lin, 1) for k, v in launches.items() if v},
            "per_ministep": _counts(reports)}


def _dd_sync(device, reset=False):
    """Wait for the card (and reset its peak-memory mark); nothing on the
    CPU, where the phases can run at small sizes."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        if reset:
            torch.cuda.reset_peak_memory_stats()


def slab_reference(res, forces, n_report=DD_SLAB_REPORTS, n_step=3):
    """srcwells' run as dd-slab's reference: the dts and forces of the
    accepted ministeps of its first ``n_report`` report steps (``res``:
    its ``simulate`` result over ``n_step`` report steps of
    ``rate_schedule(forces, n_step)``) and its state at their end."""
    if len(res.states) != len(res.reports):
        raise ValueError("the reference run must return one state per "
                         "report step")
    schedule = rate_schedule(forces, n_step)
    dts, fs = [], []
    for i, r in enumerate(res.reports[:n_report]):
        for m in r["ministeps"]:
            if m["success"]:
                dts.append(float(m["dt"]))
                fs.append(schedule[i])
    return {"dts": dts, "forces": fs, "state": res.states[n_report - 1],
            "report_steps": n_report}


def phase_dd_slab(ref, grid=GRID, n_shards=DD_SHARDS, device="cuda"):
    """The bench flagship with source-term wells at full width through the
    slab engine: ``DistributedSimulator`` over ``ShardGroup.threads(8)`` on
    the card (eight z-slabs), ``local_preconditioner="cpr"`` — the global
    pressure stencil all-gathered once per Jacobian and V-cycled by GMG on
    every shard (srcwells' GMG settings), stage 2 block-ILU(0) — in float32,
    the eager loop with dt cuts, on srcwells' accepted ministep dts and
    forces (``ref``: ``slab_reference`` of srcwells' run on ``grid``; the
    slab engine has no timestep selector). K10 and K8 must launch (all
    shards count into the process-wide counters); the final accepted
    ministep passes the f64 verify, and the final state is held against
    srcwells' at the same time: pressure within DD_SLAB_P_BAR relative,
    saturations within DD_SLAB_S_BAR."""
    from jutul.jl_tpu_torch import GMG, DistributedSimulator, ShardGroup
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model, state0, params, forces = build_flagship(*grid)
    nc = model.number_of_cells()
    setup = {}
    t0 = time.perf_counter()
    dd = model.data_domain
    dsim = DistributedSimulator(
        model.domain.mesh, model.system,
        ShardGroup.threads(n_shards, device), parameters=params,
        data_fields={"permeability": dd["permeability"],
                     "porosity": dd["porosity"]},
        local_preconditioner="cpr",
        gmg=GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384))
    setup["decomposition"] = time.perf_counter() - t0
    cfg = dd_config()
    _dd_sync(device, reset=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    states, reports = dsim.simulate(state0, ref["dts"], forces=ref["forces"],
                                    max_lin_it=25, **cfg)
    _dd_sync(device)
    wall = time.perf_counter() - t0
    out = _dd_record("dd-slab", dsim, states, reports, wall, launch_counts(),
                     setup, nc, len(ref["dts"]))
    out["k2_launches_per_linear_iteration"] = \
        out["launches_per_linear_iteration"].get("scalar_jacobi", 0)
    out["k8_launches_per_linear_iteration"] = \
        out["launches_per_linear_iteration"].get(K8, 0)
    out["k10_launches_per_linear_iteration"] = \
        out["launches_per_linear_iteration"].get(K10, 0)
    # a ministep at the Newton cap is accepted by the final-iteration
    # factor (10x the tolerances), as srcwells' own capped ministeps
    out["srcwells_report_steps"] = ref["report_steps"]
    out["ministeps_at_newton_cap"] = sum(
        m["iterations"] >= cfg["max_newton"] for r in reports
        for m in r["ministeps"] if m["success"])
    start, end, dt = dsim.last_ministep
    out["f64_verify"] = dd_f64_verify(
        model, params, dsim.gather_state(end), dsim.gather_state(start), dt,
        ref["forces"][-1], "dd-slab", device)
    a, b = states[-1], ref["state"]
    out["vs_srcwells"] = {
        "max_rel_dev_pressure": float(np.max(np.abs(
            a["Pressure"] / b["Pressure"] - 1))),
        "max_abs_dev_saturations": float(np.max(np.abs(
            a["Saturations"] - b["Saturations"]))),
        "bars": [DD_SLAB_P_BAR, DD_SLAB_S_BAR]}
    log("# dd-slab: " + json.dumps(out))
    v = out["vs_srcwells"]
    if not (v["max_rel_dev_pressure"] <= DD_SLAB_P_BAR
            and v["max_abs_dev_saturations"] <= DD_SLAB_S_BAR):
        raise RuntimeError(f"dd-slab: the final state differs from "
                           f"srcwells' at the same time: {v}")
    return out


def phase_dd_general(n_step=2, n_shards=DD_SHARDS, device="cuda",
                     grid=LAYER_GRID, lam_rtol=DD_LAMBDA_RTOL,
                     lam_its=DD_LAMBDA_ITS):
    """BASELINE configuration 5's shape: extruded-layers' reservoir
    (``layered_reservoir``: 1,048,576 extruded cells + 5 trajectory wells
    as a well graph) through ``GeneralDistributedSimulator`` over
    ``ShardGroup.threads(8)`` on the card, on the native partition into 8
    blocks with ``partition_groups()`` forced; halo_mode "auto"
    (all_to_all at 8 shards), the distributed CPR with Chebyshev
    smoothing; float32, ``n_step`` report steps of 6 h of the rate ramp,
    the final accepted ministep through the f64 verify. Then
    ``solve_adjoint_sensitivities_general`` of dryrun_multichip's pressure
    objective over the accepted ministeps in float64 (block-Jacobi
    BiCGStab λ-solves at ``lam_rtol``, at most ``lam_its`` iterations; in
    float32 neither engine reached that tolerance in 200) against the
    single-device generic adjoint of the same states in float64
    (ILU(0)-BiCGStab, same tolerance and cap): every λ-solve of both must
    converge and the gradients agree within DD_LAMBDA_GRAD_BAR relative.
    Reported: the sweep's seconds over the forward's, λ iterations per
    step, the gradients' largest relative difference."""
    import jutul.jl_tpu_torch as tp
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from jutul.jl_tpu_torch.parallel.general_adjoint import (
        GeneralDistributedAdjoint,
    )

    case, setup = _timed_case(layered_reservoir, *grid)
    model, params, state0 = case["model"], case["params"], case["state0"]
    wmesh = model.domain.mesh
    nc = model.number_of_cells()
    t0 = time.perf_counter()
    part = tp.GreedyGraphPartitioner().partition(
        wmesh.neighborship(), nc, n_shards, groups=wmesh.partition_groups())
    setup["partition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dsim = tp.GeneralDistributedSimulator(
        wmesh, None, tp.ShardGroup.threads(n_shards, device), partition=part,
        parameters=params, model=model)
    setup["decomposition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dsim._cpr_tables(0)
    setup["cpr aggregation"] = time.perf_counter() - t0
    schedule = rate_schedule(case["forces"], n_step)
    _dd_sync(device, reset=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    states, reports = dsim.simulate(
        state0, [DT] * n_step, forces=schedule, max_lin_it=50,
        preconditioner="cpr", cpr_smoother="chebyshev",
        output_substates=True, **dd_config())
    _dd_sync(device)
    wall = time.perf_counter() - t0
    out = _dd_record("dd-general", dsim, states, reports, wall,
                     launch_counts(), setup, nc, n_step)
    out.update(halo_mode=dsim.halo_mode, n_own_max=dsim.dec.n_own_max,
               n_ghost_max=dsim.dec.n_ghost_max,
               load_balance=float(np.bincount(part).max()
                                  / (nc / n_shards)))
    start, end, dt = dsim.last_ministep
    out["f64_verify"] = dd_f64_verify(
        model, params, dsim.gather_state(end), dsim.gather_state(start), dt,
        schedule[-1], "dd-general", device)
    # the adjoint over the accepted ministeps
    ms, mdts = tp.expand_to_ministeps(states, reports)
    mforces = [schedule[i] for i, r in enumerate(reports)
               for m in r["ministeps"] if m["success"]]
    G = pressure_objective(200.0 * tp.si_unit("bar"))
    t0 = time.perf_counter()
    dsim64 = tp.GeneralDistributedSimulator(
        wmesh, None, tp.ShardGroup.threads(n_shards, device), partition=part,
        parameters=params, model=model, dtype=torch.float64)
    setup["float64 adjoint engine"] = time.perf_counter() - t0
    adj = GeneralDistributedAdjoint(dsim64, parameters=params)
    _dd_sync(device)
    t0 = time.perf_counter()
    g = adj.solve(ms, mdts, G, state0, forces=mforces, rtol=lam_rtol,
                  max_lin_it=lam_its)
    _dd_sync(device)
    sweep = time.perf_counter() - t0
    storage = tp.AdjointStorage(model, params, device=device,
                                dtype=torch.float64,
                                linear_solver=generic_lambda_solver(
                                    lam_rtol, lam_its))
    t0 = time.perf_counter()
    g_ref = tp.solve_adjoint_sensitivities(
        model, ms, mdts, G, parameters=params, state0=state0,
        forces=mforces, storage=storage)
    _dd_sync(device)
    out["adjoint"] = a = {
        "ministeps": len(ms), "dtype": "float64", "sweep_s": sweep,
        "forward_s": wall, "sweep_over_forward": sweep / wall,
        "lambda_iterations_per_step": adj.lambda_iterations[::-1],
        "lambda_converged_per_step": adj.lambda_converged[::-1],
        "lambda_rtol": lam_rtol, "lambda_max_iterations": lam_its,
        "single_device_sweep_s": time.perf_counter() - t0,
        "single_device_lambda_iterations": list(
            storage.lambda_iterations[::-1]),
        "single_device_lambda_converged": list(
            storage.lambda_converged[::-1]),
        "grad_rel_diff_vs_single_device": {
            k: _grad_rel({k: g[k]}, {k: g_ref[k]}) for k in g_ref},
        "grad_bar": DD_LAMBDA_GRAD_BAR}
    log("# dd-general: " + json.dumps(out))
    if not all(np.all(np.isfinite(v)) for v in g.values()):
        raise RuntimeError("dd-general adjoint: non-finite gradient")
    if not (all(a["lambda_converged_per_step"])
            and all(a["single_device_lambda_converged"])):
        raise RuntimeError("dd-general adjoint: a λ-solve did not converge")
    if max(a["grad_rel_diff_vs_single_device"].values()) > \
            DD_LAMBDA_GRAD_BAR:
        raise RuntimeError("dd-general adjoint: the gradients differ from "
                           "the single-device adjoint's")
    return out


def dd_mm_f64_verify(mm, params, state, state0, dt, forces, device="cuda"):
    """dd-multimodel's final accepted ministep, gathered to the global
    state, re-assembled in float64 on the card by the single-device
    MultiModel engine: the f64 verify's MultiModel record, CNV and MB
    within 10x their tolerances."""
    from jutul.jl_tpu_torch import from_numpy
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.multimodel.core import compile_multi_model

    f64 = torch.float64
    cm = compile_multi_model(mm)
    pr = from_numpy(params, device, f64)
    st, st0 = from_numpy(state, device, f64), from_numpy(state0, device, f64)
    r, _, full = cm.assemble({m: merge_state(st[m], pr[m]) for m in st},
                             {m: merge_state(st0[m], pr[m]) for m in st0},
                             dt, forces, with_jacobian=False)
    out = mm_f64_record(cm, r, full, cm.convergence(r, full, dt), dt)
    log("# dd-multimodel f64 verify: " + json.dumps(out))
    if not (out["f64_CNV"] <= 10 * CNV_TOL and out["f64_MB"] <= 10 * MB_TOL):
        raise RuntimeError(f"dd-multimodel f64 verify: residual out of "
                           f"bound: {out}")
    return out


def mm_ministep_reference(sim, dts, fs):
    """wells-multimodel's engine and settings (its ``Simulator``, the
    schedule path, ``multimodel_config(product=True)``) on the given
    accepted ministeps, each as a report step of one ministep (no timestep
    selector): its state after them, and its counts."""
    cfg = multimodel_config(product=True)
    cfg["timestep_selectors"] = []
    res = sim.simulate_jit(list(dts), forces=list(fs),
                           jit_output_states=True, **cfg)
    if not all(r["success"] for r in res.reports):
        raise RuntimeError("dd-multimodel: the reference run failed")
    return res.states[-1], _counts(res.reports)


def phase_dd_multimodel(case_mm, ref, case_graph=None, ref_sim=None,
                        n_shards=DD_SHARDS,
                        device="cuda", max_lin_it=DD_MM_LIN_ITS,
                        n_ministeps=DD_MM_MINISTEPS,
                        adjoint_steps=DD_MM_ADJOINT_STEPS,
                        lam_rtol=DD_MM_LAMBDA_RTOL, lam_its=DD_LAMBDA_ITS):
    """``dd-multimodel``: BASELINE configuration 4's coupled form under
    domain decomposition — wells-multimodel's case (1,048,576 reservoir
    cells, 5 one-cell well models) with ``reduction="schur_apply"`` through
    ``GeneralDistributedMultiModel`` over ``ShardGroup.threads(8)`` on the
    card: the reservoir on 8 blocks of the native partitioner (as
    dd-general), the wells replicated; BiCGStab with Eisenstat-Walker
    forcing on block-Jacobi (at most ``max_lin_it`` iterations per Newton),
    float32, ``multimodel_config``'s per-submodel tolerances; on
    wells-multimodel's accepted ministep dts and rate-ramp forces of its
    first report step (``ref``: ``slab_reference`` of its run), the first
    ``n_ministeps`` of them, each through ``solve_timestep`` (one ministep,
    cut if it fails). No kernel may launch; the replicated wells must hold
    the same bits on every shard after every ministep; the final accepted
    ministep passes the f64 verify and the final state is held against
    wells-multimodel's at the same time (pressure DD_SLAB_P_BAR relative,
    saturations DD_SLAB_S_BAR): its recorded state at the end of the
    report step, or, when ``n_ministeps`` stops inside it, its engine and
    settings rerun on the same ministeps (``mm_ministep_reference``;
    ``ref_sim``: its ``Simulator``, when this call has one).

    Then the adjoint of dryrun_multichip's pressure objective
    (``coupled_objective``; bench.py run_adjoint's saturation objective
    needs λ-solves near 1e-8 to hold the gradients to 1e-3 against the
    well-graph form, where this one holds them to 1e-10 at 1e-6) in
    float64 over the first ``adjoint_steps`` accepted ministeps (one per
    step) of this run: the distributed MultiModel's
    (block-Jacobi BiCGStab λ-solves over the coupled transpose at
    ``lam_rtol``, at most ``lam_its``) against the single-device generic
    adjoint of the WELL-GRAPH form of the same states (``case_graph``:
    build_well_flagship's; ILU(0)-BiCGStab λ-solves), the pairing of
    ``multimodel_engine_check``: the reservoir's face transmissibilities,
    gravity differences and pore volumes are parameters of both forms one
    for one (the graph's reservoir faces and cells come first). Every
    λ-solve must converge and the gradients agree within
    DD_LAMBDA_GRAD_BAR."""
    import jutul.jl_tpu_torch as tp
    from jutul.jl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from jutul.jl_tpu_torch.parallel.multimodel import (
        GeneralDistributedMultiModel,
    )

    mm, state0, params, _forces = case_mm
    res_model = mm["reservoir"]
    nc_res = res_model.number_of_cells()
    nc = sum(m.number_of_cells() for m in mm.models.values())
    setup = {}
    dts, fs = ref["dts"][:n_ministeps], ref["forces"][:n_ministeps]
    ref_counts = None
    if len(dts) < len(ref["dts"]):
        t0 = time.perf_counter()
        if ref_sim is None:
            from jutul.jl_tpu_torch import Simulator

            ref_sim = Simulator(mm, state0, params, device=device)
        ref_state, ref_counts = mm_ministep_reference(ref_sim, dts, fs)
        ref_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
    else:
        ref_state, ref_s = ref["state"], 0.0
    saved = mm.reduction
    mm.reduction = "schur_apply"
    try:
        t0 = time.perf_counter()
        part = tp.GreedyGraphPartitioner().partition(
            res_model.domain.mesh.neighborship(), nc_res, n_shards)
        setup["partition"] = time.perf_counter() - t0
        dmm = GeneralDistributedMultiModel(
            mm, tp.ShardGroup.threads(n_shards, device), main="reservoir",
            partition=part, parameters=params)
        setup.update(dmm.setup_times)
        cfg = multimodel_config(product=True)
        kw = dict(tolerances=cfg["tolerances"],
                  max_newton=cfg["max_nonlinear_iterations"],
                  tol_factor_final_iteration=cfg[
                      "tol_factor_final_iteration"],
                  linear_forcing="ew", max_lin_it=max_lin_it)
        seen = watch_replicas(dmm)
        states, reports = [], []
        _dd_sync(device, reset=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        cur = dmm.shard_state(state0)
        for dt, f in zip(dts, fs):
            cur, _its = dmm.solve_timestep(cur, cur, dt, forces=f, **kw)
            reports.append({"ministeps": list(dmm.last_report["ministeps"]),
                            "success": True, "dt": dt})
            states.append(dmm.gather_state(cur))
            log(f"# dd-multimodel ministep {len(states)}/{len(dts)}: "
                + json.dumps(_counts(reports[-1:]))
                + f" {time.perf_counter() - t0:.1f} s")
        _dd_sync(device)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        stats = tp.report_stats(reports)
        for m, st in states[-1].items():
            for k, v in st.items():
                if not np.all(np.isfinite(v)):
                    raise RuntimeError(f"dd-multimodel: final {m}.{k} not "
                                       "finite")
        if dmm.device.type == "cuda":
            _check_launches("dd-multimodel", "dd-multimodel", launches)
        newtons, lin = stats["newtons"], stats["linear_iterations"]
        out = {"slice": "dd-multimodel", "cells": nc, "shards": n_shards,
               "dtype": str(dmm.dtype).replace("torch.", ""),
               "reduction": "schur_apply",
               "wells_multimodel_ministeps": [len(dts), len(ref["dts"])],
               "ministeps": stats["ministeps"], "newtons": newtons,
               "failed_ministeps": stats["failed_ministeps"],
               "linear_iterations": lin, "wall_s": wall,
               "s_per_newton": wall / newtons,
               "cell_newton_its_per_s": nc * newtons / wall,
               "linear_iterations_per_newton": lin / newtons,
               "ministeps_at_newton_cap": sum(
                   m["iterations"] >= kw["max_newton"] for r in reports
                   for m in r["ministeps"] if m["success"]),
               "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                                  if dmm.device.type == "cuda" else None),
               "host_setup_s": setup, "launches": launches,
               "n_own_max": dmm.gen.dec.n_own_max,
               "n_ghost_max": dmm.gen.dec.n_ghost_max,
               "replicas_bitwise": not any(seen),
               "ministeps_watched": len(seen),
               "per_ministep": _counts(reports)}
        if any(seen):
            raise RuntimeError(f"dd-multimodel: the replicated well states "
                               f"differ between shards: {seen}")
        start, end, dt = dmm.last_ministep
        out["f64_verify"] = dd_mm_f64_verify(
            mm, params, dmm.gather_state(end), dmm.gather_state(start), dt,
            fs[-1], device)
        a, b = states[-1], ref_state
        dev_p = {m: np.abs(a[m]["Pressure"] / b[m]["Pressure"] - 1)
                 for m in b}
        dev_s = {m: np.abs(a[m]["Saturations"] - b[m]["Saturations"])
                 .max(axis=-1) for m in b}
        worst = max(b, key=lambda m: float(dev_s[m].max()))
        i = int(np.argmax(dev_s[worst]))
        out["vs_wells_multimodel"] = {
            "max_rel_dev_pressure": max(float(v.max())
                                        for v in dev_p.values()),
            "max_abs_dev_saturations": max(float(v.max())
                                           for v in dev_s.values()),
            "by_model": {m: [float(dev_p[m].max()), float(dev_s[m].max())]
                         for m in b},
            "worst_saturation": {
                "model": worst, "cell": i,
                "here": a[worst]["Saturations"][i].tolist(),
                "wells_multimodel": b[worst]["Saturations"][i].tolist(),
                "cells_above_bar": int(sum((v > DD_SLAB_S_BAR).sum()
                                           for v in dev_s.values()))},
            "bars": [DD_SLAB_P_BAR, DD_SLAB_S_BAR],
            "reference": ("wells-multimodel's state at the end of its first "
                          "report step" if ref_counts is None else
                          "wells-multimodel's engine and settings rerun on "
                          "these ministeps"),
            "reference_counts": ref_counts, "reference_s": ref_s}
        log("# dd-multimodel: " + json.dumps(out))
        del dmm, cur
        torch.cuda.empty_cache()
        if adjoint_steps and case_graph is not None:
            out["adjoint"] = _dd_mm_adjoint(
                mm, params, state0, states, reports, fs, part, case_graph,
                n_shards, device, adjoint_steps, lam_rtol, lam_its, wall)
        v = out["vs_wells_multimodel"]
        if not (v["max_rel_dev_pressure"] <= DD_SLAB_P_BAR
                and v["max_abs_dev_saturations"] <= DD_SLAB_S_BAR):
            raise RuntimeError(f"dd-multimodel: the final state differs "
                               f"from wells-multimodel's: {v}")
    finally:
        mm.reduction = saved
    return out


def _dd_mm_adjoint(mm, params, state0, states, reports, fs, part,
                   case_graph, n_shards, device, n_steps, lam_rtol, lam_its,
                   forward_s):
    """dd-multimodel's float64 adjoint (see ``phase_dd_multimodel``)."""
    import jutul.jl_tpu_torch as tp
    from jutul.jl_tpu_torch.parallel.multimodel import (
        GeneralDistributedMultiModel,
    )
    from jutul.jl_tpu_torch.parallel.multimodel_adjoint import (
        GeneralDistributedMultiModelAdjoint,
    )

    gmodel, gstate0, gparams, _gf = case_graph
    order = ("reservoir",) + WELL_NAMES
    ms, mdts, mforces = [], [], []
    for st, rep, f in zip(states, reports, fs):
        ok = [m for m in rep["ministeps"] if m["success"]]
        if len(ok) != 1:
            break  # the adjoint's steps: one accepted ministep each
        ms.append(st)
        mdts.append(float(ok[0]["dt"]))
        mforces.append(f)
        if len(ms) == n_steps:
            break
    if len(ms) < n_steps:
        raise RuntimeError("dd-multimodel adjoint: fewer one-ministep steps "
                           "than asked for")
    p_ref = 200.0 * tp.si_unit("bar")
    t0 = time.perf_counter()
    dmm64 = GeneralDistributedMultiModel(
        mm, tp.ShardGroup.threads(n_shards, device), main="reservoir",
        partition=part, parameters=params, dtype=torch.float64)
    setup_s = time.perf_counter() - t0
    adj = GeneralDistributedMultiModelAdjoint(dmm64)
    _dd_sync(device)
    t0 = time.perf_counter()
    g = adj.solve(ms, mdts, coupled_objective(WELL_NAMES, p_ref), state0,
                  forces=mforces, rtol=lam_rtol, max_lin_it=lam_its)
    _dd_sync(device)
    sweep = time.perf_counter() - t0
    lam_its_steps = adj.lambda_iterations[::-1]
    lam_conv_steps = adj.lambda_converged[::-1]
    del dmm64, adj
    torch.cuda.empty_cache()

    # the well-graph form of the same states: the reservoir's cells, then
    # one wellbore cell per well in WELL_NAMES order
    def graph(st):
        return {k: np.concatenate([np.asarray(st[m][k]) for m in order])
                for k in st["reservoir"]}

    gforces = rate_schedule(_gf, 2)[0]
    storage = tp.AdjointStorage(gmodel, gparams, device=device,
                                dtype=torch.float64,
                                linear_solver=generic_lambda_solver(
                                    lam_rtol, lam_its))
    t0 = time.perf_counter()
    g_ref = tp.solve_adjoint_sensitivities(
        gmodel, [graph(st) for st in ms], mdts, pressure_objective(p_ref),
        parameters=gparams, state0=gstate0, forces=[gforces] * len(ms),
        storage=storage)
    _dd_sync(device)
    single_s = time.perf_counter() - t0
    nc = mm["reservoir"].number_of_cells()
    nf = mm["reservoir"].domain.mesh.number_of_faces()
    pairs = {}
    for k, v in g["reservoir"].items():
        ref = np.asarray(g_ref[k])
        n = nc if np.shape(v)[0] == nc else nf
        if ref.shape[0] >= n and np.asarray(v).size:
            pairs[k] = _grad_rel({k: np.asarray(v)}, {k: ref[:n]})
    out = {"ministeps": len(ms), "dts": mdts, "dtype": "float64",
           "objective": "dt sum((p / 200 bar)^2) over every model's cells",
           "sweep_s": sweep, "forward_s": forward_s,
           "sweep_over_forward": sweep / forward_s,
           "float64_engine_setup_s": setup_s,
           "lambda_iterations_per_step": lam_its_steps,
           "lambda_converged_per_step": lam_conv_steps,
           "lambda_rtol": lam_rtol, "lambda_max_iterations": lam_its,
           "reference": "single-device generic adjoint of the well-graph "
                        "form (ILU(0)-BiCGStab λ-solves)",
           "single_device_sweep_s": single_s,
           "single_device_lambda_iterations": list(
               storage.lambda_iterations[::-1]),
           "single_device_lambda_converged": list(
               storage.lambda_converged[::-1]),
           "grad_rel_diff_vs_well_graph": pairs,
           "grad_bar": DD_LAMBDA_GRAD_BAR}
    log("# dd-multimodel adjoint: " + json.dumps(out))
    if not all(np.all(np.isfinite(v)) for m in g.values()
               for v in m.values()):
        raise RuntimeError("dd-multimodel adjoint: non-finite gradient")
    if not (all(out["lambda_converged_per_step"])
            and all(out["single_device_lambda_converged"])):
        raise RuntimeError("dd-multimodel adjoint: a λ-solve did not "
                           "converge")
    if not pairs or max(pairs.values()) > DD_LAMBDA_GRAD_BAR:
        raise RuntimeError(f"dd-multimodel adjoint: the gradients differ "
                           f"from the well-graph form's: {pairs}")
    return out


def multimodel_dd_phases(device="cuda", cross_check=True):
    """``python3 chip_smoke.py --dd multimodel``: the distributed
    MultiModel's phases alone — dd-cross-check's MultiModel case (unless
    ``cross_check`` is False), then wells-multimodel (2 report steps, for
    its first report step's ministeps and state) and dd-multimodel with its
    adjoint."""
    out = {}
    if cross_check:
        t0 = time.perf_counter()
        out["dd-cross-check-multimodel"], _c = dd_cross_check_multimodel(
            device)
        log("# dd-cross-check (multimodel): "
            + json.dumps(out["dd-cross-check-multimodel"])
            + f" {time.perf_counter() - t0:.1f} s")
    case_mm = build_well_multimodel(*GRID)
    case_w = build_well_flagship(*GRID)
    sim, res, _lf, rec = phase_multimodel(case_mm, n_step=2)
    ref = slab_reference(res, case_mm[3], n_report=1, n_step=2)
    t0 = time.perf_counter()
    out["dd-multimodel"] = phase_dd_multimodel(case_mm, ref, case_w,
                                               ref_sim=sim, device=device)
    del sim, res
    torch.cuda.empty_cache()
    log(f"# dd-multimodel: {time.perf_counter() - t0:.1f} s")
    keys = ("ministeps", "newtons", "linear_iterations", "s_per_newton",
            "cell_newton_its_per_s", "peak_mem_bytes")
    log("# dd-multimodel vs wells-multimodel (same call): " + json.dumps({
        "dd-multimodel": {k: out["dd-multimodel"][k] for k in keys},
        "wells-multimodel": {k: rec[k] for k in keys}}))
    return out


def dd_phases(srcwells=None, device="cuda"):
    """The distributed phases: dd-cross-check, dd-slab and dd-general
    (``srcwells``: srcwells' record, None beside ``main``, and its
    ``slab_reference``; without it the srcwells slice runs here first).
    Returns the records."""
    out = {}
    t0 = time.perf_counter()
    out["dd-cross-check"] = phase_dd_cross_check(device)
    log(f"# dd-cross-check: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if srcwells is None:
        case = build_flagship(*GRID)
        _, res, _, rec = phase_slice(case, "srcwells", "jacobi")
        srcwells = (rec, slab_reference(res, case[3]))
        del case, res
    out["dd-slab"] = phase_dd_slab(srcwells[1], device=device)
    torch.cuda.empty_cache()
    log(f"# dd-slab: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["dd-general"] = phase_dd_general(n_step=1, device=device)
    torch.cuda.empty_cache()
    log(f"# dd-general: {time.perf_counter() - t0:.1f} s")
    log_same_call(out, srcwells[0])
    return out


def log_same_call(dd, srcwells=None, extruded=None):
    """dd-slab and dd-general beside the single-device records of the same
    call (srcwells', extruded-layers'), where given."""
    keys = ("ministeps", "newtons", "linear_iterations", "s_per_newton",
            "cell_newton_its_per_s", "peak_mem_bytes")
    for name, ref, ref_name in (("dd-slab", srcwells, "srcwells"),
                                ("dd-general", extruded, "extruded-layers")):
        if ref is not None:
            log(f"# {name} vs {ref_name} (same call): " + json.dumps({
                name: {k: dd[name][k] for k in keys},
                ref_name: {k: ref[k] for k in keys}}))


SIDE_GROUPS = ("mm", "dd", "tm")  # the processes beside main's own


def side_phases(group, slab_ref):
    """``python3 chip_smoke.py --side DIR GROUP``: a group of phases that
    ``main`` runs in a process of its own on the same card, beside its own
    from the generic phases on. ``mm``: the MultiModel phases
    (wells-multimodel, multimodel-fused, its engine check, dd-multimodel,
    the card-vs-CPU cross-check); ``dd``: the distributed ones
    (dd-cross-check, dd-slab on srcwells' ``slab_ref``, dd-general on its
    own extruded-layers case); ``tm``: the transport and meshes phases.
    Each is bound by the host (the eight shard threads take turns in one
    interpreter), so in one process they would run one after the other.
    Returns the records ``main`` reports."""
    t_start = time.perf_counter()
    out = {"slices": {}}
    slices = out["slices"]
    if group == "mm":
        warm_up_multimodel()
        case_w = build_well_flagship(*GRID)
        case_mm = build_well_multimodel(*GRID)
        sim, res, last_forces, slices["wells-multimodel"] = \
            phase_multimodel(case_mm, n_step=2)
        slices["wells-multimodel"]["f64_verify"] = phase_f64_verify(
            sim, res, last_forces, "wells-multimodel")
        slices["multimodel-fused"] = phase_multimodel_fused(sim, case_mm)
        out["mm_engine"] = phase_multimodel_engine_check(
            case_mm, case_w, res, n_step=2)
        mm_ref = slab_reference(res, case_mm[3], n_report=1, n_step=2)
        t1 = time.perf_counter()
        slices["dd-multimodel"] = phase_dd_multimodel(case_mm, mm_ref,
                                                      case_w, ref_sim=sim)
        log(f"# dd-multimodel: {time.perf_counter() - t1:.1f} s")
        del sim, res, case_mm, case_w, mm_ref
        torch.cuda.empty_cache()
        out["mm_cross"] = phase_multimodel_cross_check()
        log(f"# multimodel phases: {time.perf_counter() - t_start:.1f} s")
    elif group == "dd":
        out["dd"] = dd_phases(srcwells=(None, slab_ref))
        slices.update({k: out["dd"][k] for k in ("dd-slab", "dd-general")})
        log(f"# distributed phases: {time.perf_counter() - t_start:.1f} s")
    else:
        out["tr"] = transport_phases(n_step=1)
        slices.update({k: out["tr"][k] for k in (
            "weno-transport", "weno-transport-fused", "nfvm-pressure")})
        log(f"# transport phases: {time.perf_counter() - t_start:.1f} s")
        t0 = time.perf_counter()
        out["me"] = meshes_phases(n_step=1)
        slices.update({k: out["me"][k] for k in (
            "extruded-layers", "coarse-upscaled", "cut-fault")})
        log(f"# meshes phases: {time.perf_counter() - t0:.1f} s")
    log(f"# side {group} total {time.perf_counter() - t_start:.1f} s")
    return out


def start_side(group, slab_ref):
    """``side_phases(group, ...)`` in a process of its own: ``slab_ref``
    pickled into a temporary directory, its output into side.log there.
    The process dies with this one, and is stopped and the directory
    removed at exit. Returns (process, directory)."""
    import atexit
    import ctypes
    import pickle
    import shutil
    import signal

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    with open(os.path.join(workdir, "slab_ref.pkl"), "wb") as f:
        pickle.dump(slab_ref, f)

    def die_with_parent():  # prctl(PR_SET_PDEATHSIG, SIGKILL)
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))

    with open(os.path.join(workdir, "side.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", workdir,
             group],
            stdout=out, cwd=os.path.dirname(os.path.abspath(__file__)),
            preexec_fn=die_with_parent)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)

    atexit.register(stop)
    return proc, workdir


def finish_side(proc, workdir, timeout):
    """Waits for a side process, repeats its log and returns its records
    (its output's last line); raises if it failed."""
    try:
        rc = proc.wait(timeout=max(timeout, 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    with open(os.path.join(workdir, "side.log")) as f:
        lines = f.read().splitlines()
    for line in lines[:-1]:
        log(line)
    if rc != 0 or not lines:
        raise RuntimeError(f"the side process {proc.args[-1]} failed ({rc})")
    return json.loads(lines[-1])


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
    t0 = time.perf_counter()
    kernel_checks(case, records)
    kernel_checks_cheby(case_w, records)
    kernel_checks_krylov(records)
    kernel_checks_bf16(case_w, records)
    kernel_checks_resident(case_w, records)
    kernel_checks_slab(case_w, records)
    kernel_checks_slab(case_w, records, cheby=True)
    kernel_checks_transpose(case_w, records)
    log(f"# kernel phases: {time.perf_counter() - t0:.1f} s")
    phase_warm_up()
    slices = {}
    for name, c, smoother, kw in (
            ("srcwells", case, "jacobi", {}),
            ("wells", case_w, "chebyshev", {}),
            ("wells-jacobi-fused", case_w, "jacobi", dict(fused=True)),
            ("wells-jacobi-eager", case_w, "jacobi", {}),
            ("wells-product", case_w, "jacobi", dict(product=True)),
            ("wells-product-bf16", case_w, "jacobi",
             dict(product=True, coef_dtype="bf16")),
            ("wells-product-bf16-cheby", case_w, "chebyshev",
             dict(product=True, coef_dtype="bf16", n_step=2)),
            ("wells-product-bf16-phases", case_w, "jacobi",
             dict(product=True, coef_dtype="bf16", phases=True, n_step=2))):
        sim, res, last_forces, slices[name] = phase_slice(c, name, smoother,
                                                          **kw)
        if name == "srcwells":
            slab_ref = slab_reference(res, c[3])
        slices[name]["f64_verify"] = phase_f64_verify(sim, res, last_forces,
                                                      name)
        if name == "wells-product":
            slices[name]["refine"] = phase_refine(sim, res, last_forces)
        del sim, res
        torch.cuda.empty_cache()
    records[K10].extra["end_to_end_srcwells"] = phase_k10_share(case)
    sides = {g: start_side(g, slab_ref) for g in SIDE_GROUPS}
    t0 = time.perf_counter()
    sim, res, last_forces, slices["generic"] = phase_generic(case, n_step=2)
    slices["generic"]["f64_verify"] = phase_f64_verify(sim, res, last_forces,
                                                       "generic")
    slices["generic-fused"] = phase_generic_fused(
        sim, case, sim._solver.preconditioner.amg)
    del sim, res
    torch.cuda.empty_cache()
    slices["generic-engine-check"] = phase_generic_engine_check(case)
    log("# generic vs srcwells (same case, same call): " + json.dumps({
        k: {q: slices[k][q] for q in ("ministeps", "newtons",
                                      "linear_iterations", "s_per_newton",
                                      "cell_newton_its_per_s")}
        for k in ("srcwells", "generic")}))
    log(f"# generic phases: {time.perf_counter() - t0:.1f} s")
    del case
    t0 = time.perf_counter()
    adjoint, g_stencil, adj_states = phase_adjoint(case_w)
    t1 = time.perf_counter()
    gen_adj = phase_generic_adjoint(case_w, adj_states, g_stencil,
                                    adjoint["forward_run_s"])
    log(f"# generic-adjoint phase: {time.perf_counter() - t1:.1f} s")
    del adj_states, g_stencil
    torch.cuda.empty_cache()
    case_ab = build_well_flagship(*AB_GRID)
    adjoint["dot_test"], fd, states64 = phase_adjoint_dot(case_ab)
    gen_adj["dot_test"] = phase_generic_adjoint_dot(case_ab, fd, states64)
    adjoint["history_match"] = phase_history_match(case_ab,
                                                   max_iterations=2)
    log(f"# adjoint phases: {time.perf_counter() - t0:.1f} s")
    del case_w
    t0 = time.perf_counter()
    case_dict = build_flagship(*DICT_GRID)
    dict_hm = phase_dict_history_match(case_dict, max_iterations=2)
    gen_setup = phase_generic_setup(case_dict)
    force = phase_force_gradient()
    del case_dict
    torch.cuda.empty_cache()
    log(f"# DictParameters, setup-map and force gradients: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ab = phase_ab(case_ab, n_step=2)
    log(f"# A/B: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eager = phase_eager_options(case_ab, n_step=2)
    log(f"# eager-options: {time.perf_counter() - t0:.1f} s")
    phase_cross_check(build_flagship, SMALL, "jacobi", "srcwells")
    slices["wells-cross-check"] = phase_cross_check(
        build_well_flagship, WELL_SMALL, "chebyshev", "wells")
    slices["wells-small-bf16-cheby"] = phase_small_chains()
    phase_cross_check(build_well_flagship, WELL_SMALL, "jacobi",
                      "wells-jacobi-phases", phases=True)
    phase_cross_check(build_well_flagship, WELL_SMALL_EW, "jacobi",
                      "wells-product", product=True)
    stencil_x = phase_adjoint_cross_check(WELL_SMALL_EW)
    phase_generic_adjoint_cross_check(WELL_SMALL_EW, stencil_x)
    phase_generic_cross_check()
    t0 = time.perf_counter()
    side_out = {}
    for proc, workdir in sides.values():
        out = finish_side(proc, workdir,
                          SCRIPT_LIMIT_S - (time.perf_counter() - t_start))
        slices.update(out.pop("slices"))
        side_out.update(out)
    log(f"# waited {time.perf_counter() - t0:.1f} s for the side processes")
    mm_engine, mm_cross, dd, tr, me = (side_out[k] for k in (
        "mm_engine", "mm_cross", "dd", "tr", "me"))
    log_same_call(dd, slices["srcwells"], me["extruded-layers"])
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        rec = records[name]
        bound_ms, bound_by = rec.bound()
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": slices[MAIN_SLICE[name]]["launches"][name],
            "main_slice": MAIN_SLICE[name],
            "launches_by_slice": {
                **{k: v["launches"][name] for k, v in slices.items()},
                "wells-adjoint": adjoint["launches"][name],
                "generic-adjoint": gen_adj["launches"][name],
                "eager-options": eager["launches"][name]},
            "max_abs_err": rec.max_abs["float32"],
            "max_rel_err_f32": rec.max_rel["float32"],
            # None: the bfloat16-coefficient entries take float32 vectors
            "max_abs_err_f64": rec.max_abs.get("float64"),
            "max_rel_err_f64": rec.max_rel.get("float64"),
            "ms": rec.ms, "plain_ms": rec.plain_ms,
            "graph_ms": rec.graph_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": rec.bytes, "bound_ops": rec.ops,
            "library_ms": rec.library_ms, **rec.extra})
    log("# slices " + json.dumps({k: {q: v[q] for q in (
        "report_steps", "ministeps", "newtons", "linear_iterations",
        "wall_s")} for k, v in slices.items() if "report_steps" in v})
        + " A/B " + json.dumps(ab))
    log("# wells-adjoint " + json.dumps({k: adjoint[k] for k in (
        "forward_run_s", "sweep_s", "overhead", "lambda_iterations_per_step",
        "peak_mem_bytes")}))
    log("# generic-adjoint " + json.dumps({k: gen_adj[k] for k in (
        "sweep_s", "overhead", "lambda_iterations_per_step",
        "lambda_converged_per_step", "bicgstab_iteration_ms",
        "peak_mem_bytes", "grad_trans_rel_diff_vs_stencil")})
        + " dot " + json.dumps(gen_adj["dot_test"]["rel_err_f64"])
        + " dict-history-match " + json.dumps(dict_hm["values"])
        + " generic-setup " + json.dumps(gen_setup["rel_err"])
        + " force-gradient " + json.dumps(force["rel_err"])
        + " eager-options " + json.dumps(eager["monitored"]))
    log("# wells-multimodel " + json.dumps({k: slices["wells-multimodel"][k]
                                            for k in (
        "ministeps", "newtons", "linear_iterations", "s_per_newton",
        "cell_newton_its_per_s", "host_reads_per_newton", "peak_mem_bytes",
        "setup_tables_s", "setup_amg_hierarchy_s", "f64_verify")})
        + " multimodel-fused " + json.dumps({k: slices["multimodel-fused"][k]
                                             for k in ("iterations",
                                                       "true_rel_residual")})
        + " engine-check " + json.dumps({k: mm_engine[k] for k in (
            "residual_rel", "jv_rel", "perturbed_for_ties")})
        + " cross-check " + json.dumps({k: mm_cross[k] for k in (
            "eager", "schedule", "adjoint_rel_dev")}))
    log("# transport " + json.dumps({k: {q: tr[k][q] for q in (
        "ministeps", "newtons", "linear_iterations", "s_per_newton",
        "cell_newton_its_per_s", "peak_mem_bytes", "host_setup",
        "f64_verify")} for k in ("weno-transport", "nfvm-pressure")})
        + " fused " + json.dumps({k: tr["weno-transport-fused"]["fused"][k]
                                  for k in ("iterations",
                                            "true_rel_residual")})
        + " engine-check " + json.dumps(tr["weno-engine-check"])
        + " conditioning " + json.dumps(tr["stencil-conditioning"]))
    log("# meshes " + json.dumps({k: {q: me[k][q] for q in (
        "cells", "ministeps", "newtons", "linear_iterations", "s_per_newton",
        "cell_newton_its_per_s", "peak_mem_bytes", "host_setup_s",
        "f64_verify")} for k in ("extruded-layers", "coarse-upscaled",
                                 "cut-fault")})
        + " vtu " + json.dumps(me["extruded-layers"]["vtu"])
        + " coarse " + json.dumps({k: me["coarse-upscaled"][k] for k in (
            "blocks", "load_balance", "edge_cut", "pore_volume_rel_err")})
        + " cut " + json.dumps({k: me["cut-fault"][k] for k in (
            "grid", "cut_s", "cells_added", "volume_rel_err")})
        + " cross-check " + json.dumps(me["meshes-cross-check"]))
    log("# distributed " + json.dumps({k: {q: slices[k][q] for q in (
        "cells", "shards", "ministeps", "newtons", "linear_iterations",
        "s_per_newton", "cell_newton_its_per_s", "peak_mem_bytes",
        "host_setup_s", "f64_verify")} for k in ("dd-slab", "dd-general",
                                                 "dd-multimodel")})
        + " k2_k8_k10_per_linear_iteration " + json.dumps(
            [dd["dd-slab"][f"k{i}_launches_per_linear_iteration"]
             for i in (2, 8, 10)])
        + " adjoint " + json.dumps(dd["dd-general"]["adjoint"])
        + " dd-multimodel adjoint " + json.dumps(
            slices["dd-multimodel"].get("adjoint"))
        + " dd-multimodel vs wells-multimodel " + json.dumps({
            k: {q: slices[k][q] for q in ("ministeps", "newtons",
                                          "linear_iterations",
                                          "s_per_newton")}
            for k in ("dd-multimodel", "wells-multimodel")})
        + " cross-check " + json.dumps(dd["dd-cross-check"]))
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def profile(name):
    """``python3 chip_smoke.py --profile NAME``: one slice (``srcwells``,
    ``wells``, ``wells-jacobi-fused`` or ``wells-product``) at full size
    under
    torch.profiler after a 16x16x8 warm-up — its wall, the card's busy
    share and device time by operation. Not a check: it prints no result
    line."""
    from jutul.jl_tpu_torch import Simulator, report_stats

    build, smoother, fused, product = {
        "srcwells": (build_flagship, "jacobi", False, False),
        "wells": (build_well_flagship, "chebyshev", False, False),
        "wells-jacobi-fused": (build_well_flagship, "jacobi", True, False),
        "wells-product": (build_well_flagship, "jacobi", False, True),
    }[name]
    smi = phase_device()
    phase_build()

    def run(dims, n_step, min_cells):
        model, state0, params, forces = build(*dims)
        sim = Simulator(model, state0, params, use_stencil=True)
        entry = sim.simulate_jit if product else sim.simulate
        return lambda: entry(
            [DT] * n_step, forces=rate_schedule(forces, n_step),
            **sim_config(min_cells, smoother, fused, product=product))

    run(SMALL, 2, 64)()  # warm-up: the first use of each op
    slice_run = run(GRID, 3, 16384)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = slice_run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = report_stats(res.reports)
    rows = []  # device-side events only (kernels, copies, memsets): the
    # host-side ops' rows repeat their kernels' time
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"slice": name, "wall_s_profiled": wall,
           "ministeps": st["ministeps"], "newtons": st["newtons"],
           "linear_iterations": st["linear_iterations"],
           "device_busy_ms": busy, "busy_share": busy / 1e3 / wall,
           "device_ops": sum(r[1] for r in rows),
           "top": [[round(ms, 3), n, key[:60]] for ms, n, key in rows[:16]]}
    print(json.dumps(out))
    print(smi)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "--side":
        # one of main's side processes: --side DIR GROUP (DIR holds
        # slab_ref.pkl); its records as the last line
        import pickle

        with open(os.path.join(sys.argv[2], "slab_ref.pkl"), "rb") as f:
            side_out = side_phases(sys.argv[3], pickle.load(f))
        print(json.dumps(side_out, default=lambda o: o.tolist()),
              flush=True)
    elif len(sys.argv) >= 2 and sys.argv[1] == "--meshes":
        # the meshes slice's phases alone (a quick check; no result line):
        # --meshes [n_step]
        print(phase_device())
        meshes_phases(*(int(a) for a in sys.argv[2:3]))
    elif len(sys.argv) >= 2 and sys.argv[1] == "--dd":
        # the distributed phases alone (a quick check; no result line):
        # --dd [multimodel]
        print(phase_device())
        phase_build()
        if sys.argv[2:3] == ["multimodel"]:  # --dd multimodel
            multimodel_dd_phases()
        else:
            dd_phases()
            multimodel_dd_phases(cross_check=False)
    elif len(sys.argv) >= 2 and sys.argv[1] == "--transport":
        # the transport slice's phases alone (a quick check; no result
        # line): --transport [n_step [nx [node offset]]]
        print(phase_device())
        transport_phases(*(t(a) for t, a in zip((int, int, float),
                                                sys.argv[2:5])))
    else:
        main()
