"""Assembly kernel K3: fused two-phase Darcy face flux + Jacobian blocks.

Wrapper around ``csrc/assembly_kernels.cu``; replaces
jutul/jl_tpu/ops/pallas/assembly_kernels.py ``_kernel_axis`` (B5). For one
lattice axis it returns the face flux F and both Jacobian blocks
dF/du_L, dF/du_R of the system's ``ScalarAssemblyForm.flux`` in one pass,
as ``(neq·(1 + 2·ndof), n_faces)`` streams in B5's order::

    out[0:neq]                    F
    out[neq : neq(1+ndof)]        dF/du_L   (j-major: [j*neq + e])
    out[neq(1+ndof) : ...]        dF/du_R

The CUDA kernels are the two-phase Darcy flux written by hand over a
``Dual<4>`` number (models/darcy.py, ``scalar_assembly_form``); they take
the form's ``constants``. Two entries:

- ``darcy_flux_jacobian``: one axis, one thread per face. It serves the
  well perforations' (1, 2, np) lattice and is, on the card, the bitwise
  reference of
- ``darcy_flux_jacobian_lattice``: the three axes of a lattice in one
  launch (``StencilCompiledModel.assemble_evaluated``), xy tiles marching
  in z, each cell's density exp and mobility evaluated once (one thread
  per cell and phase) and shared by its six faces through registers (±z)
  and shared memory (±x, ±y), with the per-axis kernel's face arithmetic
  on the partials that are not structurally zero; the owned columns are
  aligned to 32 so that outputs are written in whole lines.

The plain version differentiates ``form.flux`` with ``torch.func.jvp``
(2·ndof tangents); the lattice entry's plain version is it, per axis. The
least time is set by HBM bytes (2 dofs per cell and 2 face parameters in,
10 streams out per face); the kernels are held back by their instructions
(the Dual arithmetic, exp, pow and divisions).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.func import jvp

from ._build import check, dtype_suffix, load_library, stream_handle
from .stencil_kernels import AXIS_SLICES, _is_cpu, _require


def face_lattice(L, axis: int):
    nz, ny, nx = L
    return (nz - (axis == 2), ny - (axis == 1), nx - (axis == 0))


def darcy_flux_jacobian_plain(form, U, trans, gdz, L, axis: int):
    """Plain version of K3: ``form.flux`` and its 2·ndof directional
    derivatives over every face of ``axis``. ``U`` (n, ndof) packed dofs;
    ``trans``/``gdz`` (n_faces,) on the axis's face lattice. The flux
    gets no cell parameters (the Darcy flux reads none)."""
    nz, ny, nx = L
    ndof = U.shape[1]
    U_lat = U.T.reshape(ndof, nz, ny, nx)
    sl_l, sl_r = AXIS_SLICES[axis]
    u_l = tuple(U_lat[j][sl_l].reshape(-1) for j in range(ndof))
    u_r = tuple(U_lat[j][sl_r].reshape(-1) for j in range(ndof))
    fp = (trans, gdz)

    def flux2(ul, ur):
        return form.flux(ul, ur, (), (), fp)

    outs = list(flux2(u_l, u_r))
    zeros = tuple(torch.zeros_like(u_l[0]) for _ in range(ndof))
    for side in (0, 1):
        for j in range(ndof):
            ej = tuple(torch.ones_like(u_l[0]) if k == j else
                       torch.zeros_like(u_l[0]) for k in range(ndof))
            tangents = (ej, zeros) if side == 0 else (zeros, ej)
            _, t = jvp(flux2, (u_l, u_r), tangents)
            outs.extend(t)
    return torch.stack(outs)


def darcy_flux_jacobian(form, U, trans, gdz, L, axis: int):
    """K3 wrapper (see the module docstring for the output layout)."""
    if _is_cpu(U):
        return darcy_flux_jacobian_plain(form, U, trans, gdz, L, axis)
    nz, ny, nx = L
    nf = int(np.prod(face_lattice(L, axis)))
    if len(form.constants) != 12 or form.n_eq != 2:
        raise ValueError("darcy_flux_jacobian: the CUDA kernel takes the "
                         "two-phase Darcy form (12 fluid constants)")
    U = U.contiguous()
    _require(trans, U, "darcy_flux_jacobian trans")
    _require(gdz, U, "darcy_flux_jacobian gdz")
    if U.shape != (nz * ny * nx, 2) or trans.shape != (nf,) \
            or gdz.shape != (nf,):
        raise ValueError(f"darcy_flux_jacobian: bad shapes U "
                         f"{tuple(U.shape)}, faces {tuple(trans.shape)}/"
                         f"{tuple(gdz.shape)} for L={L}, axis={axis}")
    out = torch.empty((10, nf), dtype=U.dtype, device=U.device)
    consts = (ctypes.c_double * 12)(*form.constants)
    lib = load_library()
    check(lib.fn("jt_darcy_flux_jacobian", dtype_suffix(U))(
        U.data_ptr(), trans.data_ptr(), gdz.data_ptr(), out.data_ptr(),
        int(axis), nz, ny, nx, ctypes.cast(consts, ctypes.c_void_p),
        stream_handle()), "darcy_flux_jacobian")
    darcy_flux_jacobian.launches += 1
    return out


darcy_flux_jacobian.launches = 0


def darcy_flux_jacobian_lattice_plain(form, U, face_params_by_axis, L):
    """Plain version of the three-axis entry: the per-axis plain version
    on each axis (an axis without faces gives a (streams, 0) output)."""
    outs = []
    for a, fp in enumerate(face_params_by_axis):
        if int(np.prod(face_lattice(L, a))) == 0:
            outs.append(U.new_zeros((form.n_eq * (1 + 2 * U.shape[1]), 0)))
        else:
            outs.append(darcy_flux_jacobian_plain(form, U, *fp, L, a))
    return outs


def darcy_flux_jacobian_lattice(form, U, face_params_by_axis, L):
    """K3 over the whole lattice in one launch: the three ``(10,
    n_faces_a)`` outputs of ``darcy_flux_jacobian(form, U, *fp_a, L, a)``
    for a = 0, 1, 2, with ``face_params_by_axis[a] = (trans_a, gdz_a)``."""
    if _is_cpu(U):
        return darcy_flux_jacobian_lattice_plain(form, U, face_params_by_axis,
                                                 L)
    nz, ny, nx = L
    if len(form.constants) != 12 or form.n_eq != 2:
        raise ValueError("darcy_flux_jacobian_lattice: the CUDA kernel takes "
                         "the two-phase Darcy form (12 fluid constants)")
    U = U.contiguous()
    if U.shape != (nz * ny * nx, 2) or len(face_params_by_axis) != 3:
        raise ValueError(f"darcy_flux_jacobian_lattice: bad U "
                         f"{tuple(U.shape)} or {len(face_params_by_axis)} "
                         f"axes for L={L}")
    ptrs, outs = [], []
    for a, fp in enumerate(face_params_by_axis):
        nf = int(np.prod(face_lattice(L, a)))
        if len(fp) != 2:
            raise ValueError("darcy_flux_jacobian_lattice: each axis takes "
                             "(trans, gdz)")
        for name, t in zip(("trans", "gdz"), fp):
            _require(t, U, f"darcy_flux_jacobian_lattice {name}[{a}]")
            if t.shape != (nf,):
                raise ValueError(f"darcy_flux_jacobian_lattice: {name}[{a}] "
                                 f"{tuple(t.shape)}, expected ({nf},)")
            ptrs.append(t.data_ptr() if nf else None)
        outs.append(torch.empty((10, nf), dtype=U.dtype, device=U.device))
    consts = (ctypes.c_double * 12)(*form.constants)
    lib = load_library()
    check(lib.fn("jt_darcy_flux_jacobian_lattice", dtype_suffix(U))(
        U.data_ptr(), *ptrs,
        *(o.data_ptr() if o.numel() else None for o in outs), nz, ny, nx,
        ctypes.cast(consts, ctypes.c_void_p), stream_handle()),
        "darcy_flux_jacobian_lattice")
    darcy_flux_jacobian_lattice.launches += 1
    return outs


darcy_flux_jacobian_lattice.launches = 0
