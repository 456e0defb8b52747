"""jutul.jl_tpu_torch — the PyTorch/CUDA port of ``jutul.jl_tpu``.

A second package beside the JAX one, with the same module layout. It runs
the structured-grid main path — two-phase immiscible Darcy flow on a
Cartesian lattice, with wells as source terms or as well models (bordered
stencil + Schur-eliminated wellbores), through
``Simulator(use_stencil=True)``: fused-form stencil assembly,
CPR(GMG)-preconditioned BiCGStab with a Jacobi or Chebyshev smoother,
adaptive ministeps —
in PyTorch, with hand-written CUDA kernels for Hopper (``ops/cuda``,
sources in ``csrc/``) where the JAX package has Pallas kernels. On CPU
tensors every kernel wrapper runs its plain PyTorch version.

The port imports neither ``jax`` nor ``jutul.jl_tpu``; states and
parameters built by either package move across as numpy arrays
(``from_numpy``).
"""

from . import dtypes  # noqa: F401  (TF32 off)
from .config import JutulConfig
from .core.domains import DataDomain, DiscretizedDomain
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
from .models.wells import WellGraphMesh, WellSpec, setup_well_graph_model
from .ops.assembly import CompiledModel, compile_model
from .ops.stencil import GMG, StencilCPR, StencilKrylovSolver
from .simulator.io import report_stats
from .simulator.simulator import SimResult, Simulator, simulate, simulator_config
from .simulator.timesteps import IterationTimestepSelector, TimestepSelector
from .units import si_unit, si_units

__all__ = [
    "CartesianMesh", "CompiledModel", "DataDomain", "DiscretizedDomain",
    "GMG", "ImmiscibleFluid", "IterationTimestepSelector", "JutulConfig",
    "PhaseSourceTerm", "PressureBoundaryCondition", "SimResult",
    "SimulationModel", "Simulator", "StencilCPR", "StencilKrylovSolver",
    "TimestepSelector", "WellGraphMesh", "WellSpec", "compile_model",
    "from_numpy", "report_stats", "setup_darcy_model", "setup_forces",
    "setup_parameters", "setup_state", "setup_well_graph_model", "si_unit",
    "si_units", "simulate", "simulator_config",
]
