"""Hand-written CUDA kernels for Hopper (counterpart of ``ops/pallas/``).

Each wrapper launches its kernel on CUDA tensors, runs its plain PyTorch
version on CPU tensors, and counts its launches in ``<wrapper>.launches``.
"""

from .assembly_kernels import darcy_flux_jacobian  # noqa: F401
from .stencil_kernels import (  # noqa: F401
    ScalarLevel,
    StencilMatvec,
    scalar_chebyshev,
    scalar_jacobi,
    stencil_matvec,
)

KERNELS = {
    "stencil_matvec": stencil_matvec,
    "scalar_jacobi": scalar_jacobi,
    "darcy_flux_jacobian": darcy_flux_jacobian,
    "scalar_chebyshev": scalar_chebyshev,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
