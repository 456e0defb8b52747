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
(``setup_well_multimodel``) and their adjoint, and the transport slice on
the generic engine: ``UnstructuredMesh`` (``meshes/unstructured.py``),
WENO and NFVM face discretizations (``discretization/``),
``TransportSystem`` and ``NFVMPressureSystem`` (``models/transport.py``),
``CompositeSystem``, ``HelperSimulator``, the vectorization module with
the DataDomain -> parameters chain rule, and table interpolation
(``interpolation.py``) — and the rest of the meshes: extruded layers with
quality checks, well trajectories, coarse meshes and data coarsening,
radial and spiral meshes, plane and surface cuts, gluing, embedded
fracture surfaces, entity tags (``meshes/``), the native C++ partitioner,
RCM and AMG aggregation (``native/``, built with g++ at first use), the
graph partitioners (``parallel/partition.py``), the distributed engines —
slab and general-partition SPMD Newton with their distributed CPR and
adjoints and the dd submodel extraction, over a ``ShardGroup`` of threads
on one device or of ``torch.distributed`` ranks (``parallel/``) — and the
VTK, Gmsh, MRST,
plotting and timing utilities (``utils/``) — in PyTorch, with hand-written CUDA kernels
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
from .core.entities import (
    BoundaryFaces,
    Cells,
    Faces,
    HalfFaces,
    NoEntity,
    Nodes,
)
from .discretization.tpfa import (
    compute_boundary_trans,
    compute_face_gdz,
    compute_face_trans,
    compute_half_face_trans,
    expand_perm,
    half_face_map,
)
from .interpolation import (
    BilinearInterpolant,
    LinearInterpolant,
    UnaryTabulatedVariable,
    get_1d_interpolator,
    get_2d_interpolator,
)
from .linsolve.amg import AMGPreconditioner, SmoothedAggregationAMG
from .linsolve.cpr import CPRPreconditioner
from .linsolve.direct import DirectSolver
from .linsolve.krylov import GenericKrylov, bicgstab, gmres
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
from .meshes.cartesian import CartesianMesh, JutulMesh, tpfv_geometry
from .meshes.coarse import CoarseMesh, coarsen_data_domain
from .meshes.cutcell import (
    PlaneCut,
    SurfaceCut,
    cut_mesh,
    embed_mesh,
    glue_mesh,
    merge_faces,
)
from .meshes.embedded import (
    SurfaceMesh,
    embed_surface,
    fracture_matrix_trans,
)
from .meshes.extruded import (
    check_and_fix_mesh,
    check_mesh,
    check_mesh_quality,
    extrude_mesh,
    face_planarity,
)
from .meshes.radial import radial_mesh, spiral_mesh
from .meshes.tags import (
    MeshEntityTags,
    get_mesh_entity_tag,
    set_mesh_entity_tag,
)
from .meshes.trajectories import (
    find_enclosing_cells,
    trajectory_intersections,
)
from .meshes.unstructured import (
    IndexRenumerator,
    IndirectionMap,
    UnstructuredMesh,
)
from .models.composite import CompositeSystem
from .models.darcy import (
    ImmiscibleFluid,
    PhaseSourceTerm,
    PressureBoundaryCondition,
    setup_darcy_model,
)
from .models.equations import (
    AccumulationContribution,
    CellTermContribution,
    ConservationLaw,
    FaceFluxContribution,
    JutulEquation,
)
from .models.forces import JutulForce, SourceTerm, setup_forces
from .models.helper import (
    HelperSimulator,
    model_accumulation,
    model_residual,
)
from .models.setup import (
    from_numpy,
    setup_parameters,
    setup_state,
    setup_state_and_parameters,
)
from .models.system import JutulSystem, SimulationModel
from .models.transport import NFVMPressureSystem, TransportSystem
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
    FractionVariables,
    FunctionSecondaryVariable,
    JutulParameter,
    JutulVariable,
    ScalarVariable,
    SecondaryVariable,
    VectorVariables,
    secondary_variable,
)
from .models.vectorization import (
    data_domain_parameter_gradient,
    devectorize_variables,
    parameters_from_data_domain,
    parameters_jacobian_wrt_data_domain,
    vectorize_variables,
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
from .ops.stencil import (
    GMG,
    StencilCPR,
    StencilCompiledModel,
    StencilKrylovSolver,
)
from .parallel.adjoint import solve_adjoint_sensitivities_distributed
from .parallel.comm import ShardGroup
from .parallel.dd import subdomain, subforces, submodel, substate
from .parallel.general import GeneralDistributedSimulator
from .parallel.general_adjoint import solve_adjoint_sensitivities_general
from .parallel.partition import (
    GreedyGraphPartitioner,
    LinearPartitioner,
    MetisPartitioner,
)
from .parallel.sharded import DistributedSimulator, simulate_parray
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
from .units import convert_from_si, convert_to_si, si_unit, si_units
from .utils.gmsh import mesh_from_gmsh
from .utils.mrst import mesh_from_mat, mesh_from_mrst_grid
from .utils.plotting import triangulate_mesh

# the JAX package's alias (its reference LUSolver: the dense direct solve)
LUSolver = DirectSolver

__all__ = [
    "AMGPreconditioner", "AccumulationContribution", "AdditiveCrossTerm",
    "AdjointStorage", "BilinearInterpolant", "BlockELL",
    "BlockJacobiPreconditioner", "BoundaryFaces", "CPRPreconditioner",
    "CartesianMesh", "CellTermContribution", "Cells", "CoarseMesh",
    "CompiledModel", "CompositeSystem", "ConservationLaw",
    "ConstantVariables", "ConvergenceMonitorCuttingCriterion",
    "ConvergenceMonitorRelaxation", "CrossTerm", "DataDomain",
    "DictParameters", "DictParametersSampler", "DirectSolver",
    "DiscretizedDomain", "DistributedSimulator", "ELLStructure",
    "EndTimeTerminationCriterion", "FaceFluxContribution", "Faces",
    "FractionVariables", "FunctionSecondaryVariable", "GMG",
    "GeneralDistributedSimulator", "GenericKrylov", "GlobalObjective",
    "GreedyGraphPartitioner", "GroupWisePreconditioner", "HalfFaces",
    "HelperSimulator", "ILU0Preconditioner", "ImmiscibleFluid",
    "IndexRenumerator", "IndirectionMap", "IterationTimestepSelector",
    "JacobiPreconditioner", "JutulCase", "JutulConfig", "JutulEquation",
    "JutulForce", "JutulMesh", "JutulParameter", "JutulSystem",
    "JutulVariable", "LUSolver", "LimitByFailedTimestepSelector",
    "LinearInterpolant", "LinearPartitioner", "LinearizedSystem",
    "MeshEntityTags", "MetisPartitioner", "MultiModel", "NFVMPressureSystem",
    "NoEntity", "NoRelaxation", "Nodes", "PhaseSourceTerm", "PlaneCut",
    "PoissonSource", "PressureBoundaryCondition", "SPAI0Preconditioner",
    "ScalarTestCrossTerm", "ScalarTestDomain", "ScalarTestForce",
    "ScalarTestSystem", "ScalarVariable", "SchurComplementSolver",
    "SecondaryVariable", "ShardGroup", "SimResult", "SimpleHeatSystem",
    "SimpleRelaxation", "SimulationModel", "Simulator",
    "SmoothedAggregationAMG", "SourceTerm", "StencilCPR",
    "StencilCompiledModel", "StencilKrylovSolver", "SumObjective",
    "SurfaceCut", "SurfaceMesh", "TerminationCriterion", "TimestepSelector",
    "TransportSystem", "TrivialPreconditioner", "UnaryTabulatedVariable",
    "UnstructuredMesh", "VariableChangeTimestepSelector",
    "VariablePoissonSystem", "VectorVariables", "WellGraphMesh", "WellSpec",
    "add_cross_term", "bicgstab", "box_trust_region", "check_and_fix_mesh",
    "check_mesh", "check_mesh_quality", "coarsen_data_domain",
    "compile_model", "compute_boundary_trans", "compute_distance",
    "compute_face_gdz", "compute_face_trans", "compute_half_face_trans",
    "convert_from_si", "convert_to_si", "cut_mesh",
    "data_domain_parameter_gradient", "devectorize_variables", "embed_mesh",
    "embed_surface", "expand_perm", "expand_to_ministeps", "extrude_mesh",
    "face_planarity", "find_enclosing_cells", "fracture_matrix_trans",
    "free_optimization_parameter", "freeze_optimization_parameter",
    "from_numpy", "get_1d_interpolator", "get_2d_interpolator",
    "get_mesh_entity_tag", "glue_mesh", "gmres", "half_face_map",
    "merge_faces", "mesh_from_gmsh", "mesh_from_mat", "mesh_from_mrst_grid",
    "model_accumulation", "model_residual", "nonconverged_equations",
    "optimization_config", "optimize", "parameters_from_data_domain",
    "parameters_gradient", "parameters_jacobian_wrt_data_domain",
    "print_stats", "radial_mesh", "read_results", "report_stats",
    "scaled_residual_norm", "secondary_variable", "set_mesh_entity_tag",
    "setup_adjoint_storage", "setup_darcy_model", "setup_forces",
    "setup_parameter_optimization", "setup_parameters", "setup_state",
    "setup_state_and_parameters", "setup_well_graph_model", "si_unit",
    "si_units", "simulate", "simulate_parray", "simulator_config",
    "solve_adjoint_forces", "solve_adjoint_generic",
    "solve_adjoint_sensitivities", "solve_adjoint_sensitivities_distributed",
    "solve_adjoint_sensitivities_general", "solve_adjoint_sensitivities_jit",
    "solve_numerical_sensitivities", "spiral_mesh", "state_gradient",
    "store_output", "subdomain", "subforces", "submodel", "substate",
    "timing_breakdown", "tpfv_geometry", "trajectory_intersections",
    "triangulate_mesh", "unit_box_bfgs", "valid_restart_indices",
    "vectorize_variables",
]
