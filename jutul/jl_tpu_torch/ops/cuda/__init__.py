"""Hand-written CUDA kernels for Hopper (counterpart of ``ops/pallas/``).

Each wrapper launches its kernel on CUDA tensors, runs its plain PyTorch
version on CPU tensors, and counts its launches in ``<wrapper>.launches``.
"""

from .assembly_kernels import (  # noqa: F401
    darcy_flux_jacobian,
    darcy_flux_jacobian_lattice,
)
from .krylov_kernels import fused_alpha_s, fused_omega_update  # noqa: F401
from .stencil_kernels import (  # noqa: F401
    ScalarLevel,
    StencilMatvec,
    scalar_chebyshev,
    scalar_chebyshev_resident,
    scalar_chebyshev_slab,
    scalar_jacobi,
    scalar_jacobi_slab,
    scalar_sweeps_resident,
    stencil_matvec,
)

KERNELS = {
    "stencil_matvec": stencil_matvec,
    "scalar_jacobi": scalar_jacobi,
    "darcy_flux_jacobian": darcy_flux_jacobian,
    "darcy_flux_jacobian_lattice": darcy_flux_jacobian_lattice,
    "scalar_chebyshev": scalar_chebyshev,
    "fused_alpha_s": fused_alpha_s,
    "fused_omega_update": fused_omega_update,
    "scalar_sweeps_resident": scalar_sweeps_resident,
    "scalar_chebyshev_resident": scalar_chebyshev_resident,
    "scalar_jacobi_slab": scalar_jacobi_slab,
    "scalar_chebyshev_slab": scalar_chebyshev_slab,
}
# the bfloat16-coefficient entries of K1, K2, K4 and K8-K11 count apart
KERNELS_BF16C = {
    "stencil_matvec_bf16c": stencil_matvec,
    "scalar_jacobi_bf16c": scalar_jacobi,
    "scalar_chebyshev_bf16c": scalar_chebyshev,
    "scalar_sweeps_resident_bf16c": scalar_sweeps_resident,
    "scalar_chebyshev_resident_bf16c": scalar_chebyshev_resident,
    "scalar_jacobi_slab_bf16c": scalar_jacobi_slab,
    "scalar_chebyshev_slab_bf16c": scalar_chebyshev_slab,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in KERNELS_BF16C.values():
        fn.launches_bf16c = 0
    stencil_matvec.launches_by_shape.clear()


def launch_counts() -> dict:
    out = {name: fn.launches for name, fn in KERNELS.items()}
    out.update({name: fn.launches_bf16c
                for name, fn in KERNELS_BF16C.items()})
    return out
