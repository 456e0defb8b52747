"""Precision and device placement for the PyTorch port.

Counterpart of the JAX package's ``dtypes.py`` and ``core/context.py``
(reference: Jutul's ``float_type(context)``, src/context.jl:12-92). There
is no process-wide default dtype: ``Simulator`` and the setup functions
take an explicit ``device`` and ``dtype``, and tensors carry both.

- On the CPU the working dtype defaults to float64, the reference's
  precision, which the conformance tests compare at.
- On a CUDA card it defaults to float32, the product precision.
- With no device given, everything runs on the card; without one it
  raises (pass ``device="cpu"`` for the CPU).

TF32 is switched off for every float32 matrix product and convolution.
Every contraction in this package sits on a Jacobian or preconditioner
path, where silently rounding inputs to 10 mantissa bits leaves answers
correct but slows Newton and Krylov convergence — the same trap as the
bf16 MXU default the JAX package guards against with HIGHEST matmul
precision.
"""

from __future__ import annotations

import torch

# TF32 keeps ~3 decimal digits; a convergence-rate hazard on every
# Jacobian/preconditioner contraction (see the module docstring).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The torch device for ``device``. ``None`` means the CUDA card: the
    port's entry points run on the card unless the caller asks for the
    CPU, and with no card they raise rather than fall back quietly.
    Asking for CUDA on a machine without it raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card (torch.cuda.is_available() is False) and no "
                "device given: pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False")
    return dev


def float_type(device=None) -> torch.dtype:
    """Default working float dtype on ``device`` (``None``: the card, as
    ``resolve_device``): float64 on the CPU, float32 on a CUDA card."""
    return torch.float32 if resolve_device(device).type == "cuda" \
        else torch.float64
