"""jutul.jl_tpu_torch — the PyTorch/CUDA port of ``jutul.jl_tpu``.

A second package beside the JAX one, with the same module layout. It runs
the structured-grid main path — two-phase immiscible Darcy flow on a
Cartesian lattice, with wells as source terms or as well models (bordered
stencil + Schur-eliminated wellbores), through
``Simulator(use_stencil=True)``: fused-form stencil assembly,
CPR(GMG)-preconditioned BiCGStab with a Jacobi or Chebyshev smoother
(optionally streaming its coefficients in bfloat16), adaptive ministeps
through the eager loop (``simulate``) or the schedule path with
Eisenstat-Walker forcing (``simulate_jit`` / ``lower_schedule``), and
mixed-precision refinement of an accepted step (``refine_solution``),
the eager loop's hooks, criteria, output files and restarts
(``simulator/``), the discrete adjoint on either engine with the force
gradient, the setup-map adjoint, the objectives, the
parameter-optimization harness and ``DictParameters`` (``adjoint/``,
``core/case.py``) — and the generic block-ELL engine on any mesh, the
default as in the JAX package (``Simulator(use_stencil=False)``,
``ops/assembly.py``, ``ops/blockell.py``) with its linear solvers: GMRES
and BiCGStab (``GenericKrylov``), the preconditioners, aggregation and
smoothed-aggregation AMG, CPR(AMG + ILU(0)) and the dense direct solve
(``linsolve/``), the analytic test systems
(``models/test_systems.py``), and MultiModel — coupled submodels with
cross-terms (``multimodel/``), Schur group reduction
(``linsolve/schur.py``), per-submodel preconditioning, mixed-entity models
(``ops/mixed.py``), the bench flagship's wells as coupled models
(``setup_well_multimodel``) and their adjoint — in PyTorch, with hand-written CUDA kernels
for Hopper (``ops/cuda``, sources in ``csrc/``) where the JAX package has Pallas kernels. On CPU
tensors every kernel wrapper runs its plain PyTorch version.

The port imports neither ``jax`` nor ``jutul.jl_tpu``; states and
parameters built by either package move across as numpy arrays
(``from_numpy``).
"""

from . import dtypes  # noqa: F401  (TF32 off)
from .adjoint.gradients import (
    AdjointStorage,
    setup_adjoint_storage,
    solve_adjoint_forces,
    solve_adjoint_sensitivities,
    solve_adjoint_sensitivities_jit,
    solve_numerical_sensitivities,
    state_gradient,
)
from .adjoint.dict_opt import (
    DictParameters,
    DictParametersSampler,
    free_optimization_parameter,
    freeze_optimization_parameter,
    optimize,
    parameters_gradient,
)
from .adjoint.generic import solve_adjoint_generic
from .adjoint.lbfgs import unit_box_bfgs
from .adjoint.objectives import GlobalObjective, SumObjective
from .adjoint.optimization import (
    optimization_config,
    setup_parameter_optimization,
)
from .adjoint.trust_region import box_trust_region
from .config import JutulConfig
from .core.case import JutulCase
from .core.domains import DataDomain, DiscretizedDomain
from .linsolve.amg import AMGPreconditioner, SmoothedAggregationAMG
from .linsolve.cpr import CPRPreconditioner
from .linsolve.direct import DirectSolver
from .linsolve.krylov import GenericKrylov
from .linsolve.precond import (
    BlockJacobiPreconditioner,
    GroupWisePreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SPAI0Preconditioner,
    TrivialPreconditioner,
)
from .linsolve.schur import SchurComplementSolver
from .linsolve.system import LinearizedSystem
from .meshes.cartesian import CartesianMesh
from .models.darcy import (
    ImmiscibleFluid,
    PhaseSourceTerm,
    PressureBoundaryCondition,
    setup_darcy_model,
)
from .models.forces import setup_forces
from .models.setup import from_numpy, setup_parameters, setup_state
from .models.system import SimulationModel
from .models.test_systems import (
    PoissonSource,
    ScalarTestCrossTerm,
    ScalarTestDomain,
    ScalarTestForce,
    ScalarTestSystem,
    SimpleHeatSystem,
    VariablePoissonSystem,
)
from .models.variables import (
    ConstantVariables,
    FunctionSecondaryVariable,
    secondary_variable,
)
from .models.wells import WellGraphMesh, WellSpec, setup_well_graph_model
from .multimodel.core import (
    AdditiveCrossTerm,
    CrossTerm,
    MultiModel,
    add_cross_term,
)
from .ops.assembly import CompiledModel, compile_model
from .ops.blockell import BlockELL, ELLStructure
from .ops.stencil import GMG, StencilCPR, StencilKrylovSolver
from .simulator.convergence_monitors import (
    ConvergenceMonitorCuttingCriterion,
    ConvergenceMonitorRelaxation,
)
from .simulator.distance_functions import (
    compute_distance,
    nonconverged_equations,
    scaled_residual_norm,
)
from .simulator.io import (
    print_stats,
    read_results,
    report_stats,
    store_output,
    timing_breakdown,
    valid_restart_indices,
)
from .simulator.relaxation import NoRelaxation, SimpleRelaxation
from .simulator.simulator import (
    SimResult,
    Simulator,
    expand_to_ministeps,
    simulate,
    simulator_config,
)
from .simulator.reporting import (
    EndTimeTerminationCriterion,
    TerminationCriterion,
)
from .simulator.timesteps import (
    IterationTimestepSelector,
    LimitByFailedTimestepSelector,
    TimestepSelector,
    VariableChangeTimestepSelector,
)
from .units import si_unit, si_units

__all__ = [
    "AMGPreconditioner", "AdditiveCrossTerm", "AdjointStorage", "BlockELL",
    "BlockJacobiPreconditioner", "CPRPreconditioner", "CartesianMesh",
    "CompiledModel", "ConstantVariables", "CrossTerm",
    "ConvergenceMonitorCuttingCriterion", "ConvergenceMonitorRelaxation",
    "DataDomain", "DictParameters", "DictParametersSampler",
    "DirectSolver", "DiscretizedDomain", "ELLStructure",
    "EndTimeTerminationCriterion", "FunctionSecondaryVariable", "GMG",
    "GenericKrylov", "GlobalObjective", "GroupWisePreconditioner",
    "ILU0Preconditioner",
    "ImmiscibleFluid", "IterationTimestepSelector", "JacobiPreconditioner",
    "JutulCase", "JutulConfig", "LimitByFailedTimestepSelector",
    "LinearizedSystem", "MultiModel", "NoRelaxation", "PhaseSourceTerm",
    "PoissonSource",
    "PressureBoundaryCondition", "SPAI0Preconditioner",
    "ScalarTestCrossTerm", "SchurComplementSolver", "ScalarTestDomain",
    "ScalarTestForce", "ScalarTestSystem", "SimResult", "SimpleHeatSystem",
    "SimpleRelaxation", "SimulationModel", "Simulator",
    "SmoothedAggregationAMG", "StencilCPR", "StencilKrylovSolver",
    "SumObjective", "TerminationCriterion", "TimestepSelector",
    "TrivialPreconditioner", "VariableChangeTimestepSelector",
    "VariablePoissonSystem", "WellGraphMesh", "WellSpec",
    "add_cross_term", "box_trust_region", "compile_model", "compute_distance",
    "expand_to_ministeps", "free_optimization_parameter",
    "freeze_optimization_parameter", "from_numpy",
    "nonconverged_equations", "optimization_config", "optimize",
    "parameters_gradient", "print_stats", "read_results", "report_stats",
    "scaled_residual_norm", "secondary_variable", "setup_adjoint_storage",
    "setup_darcy_model", "setup_forces", "setup_parameter_optimization",
    "setup_parameters", "setup_state", "setup_well_graph_model", "si_unit",
    "si_units", "simulate", "simulator_config", "solve_adjoint_forces",
    "solve_adjoint_generic", "solve_adjoint_sensitivities",
    "solve_adjoint_sensitivities_jit", "solve_numerical_sensitivities",
    "state_gradient", "store_output", "timing_breakdown", "unit_box_bfgs",
    "valid_restart_indices",
]
