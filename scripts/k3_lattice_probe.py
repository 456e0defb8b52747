"""Time K3's three-axis launch (``darcy_flux_jacobian_lattice``) against
three per-axis launches on a CUDA card.

    python3 scripts/k3_lattice_probe.py [--sass]

On the source-term flagship (256x64x64, float32, as chip_smoke.py
``kernel_checks``): checks the three-axis launch bitwise equal to the three
per-axis launches, then times both as CUDA-graph replays in turns
(per-axis, lattice, lattice, per-axis). ``--sass`` also prints the
instruction count of each K3 kernel from cuobjdump.
Not a check beyond the bitwise one: it prints one JSON line and the card's
name and power limit.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import graph_ms, phase_device  # noqa: E402
from jutul.jl_tpu_torch.ops.cuda._build import load_library  # noqa: E402


def sass_counts():
    """Instructions per K3 kernel from cuobjdump of the built library."""
    lib = load_library()
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return {k: v for k, v in counts.items() if "flux" in k}


def k3_rows():
    from chip_smoke import GRID, _flagship_state, build_flagship
    from jutul.jl_tpu_torch import compile_model
    from jutul.jl_tpu_torch.models.setup import merge_state
    from jutul.jl_tpu_torch.ops.cuda import assembly_kernels as AK
    from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel

    model, state0, params, _ = build_flagship(*GRID)
    sc = StencilCompiledModel(compile_model(model))
    st, pr = _flagship_state(model, state0, params, torch.float32)
    full = sc.comp.evaluate_secondaries(merge_state(st, pr))
    U = sc.comp.get_dofs(full).contiguous()
    faces = sc.comp._face_entries(full)
    fps = [tuple(sc._axis_face_state(faces, a)[nm]
                 for nm in sc.form.face_params) for a in range(3)]
    per_axis = lambda: [AK.darcy_flux_jacobian(sc.form, U, *fps[a], sc.L, a)  # noqa: E731
                        for a in range(3)]
    lattice = lambda: AK.darcy_flux_jacobian_lattice(sc.form, U, fps, sc.L)  # noqa: E731
    equal = all(torch.equal(x, y) for x, y in zip(per_axis(), lattice()))
    if not equal:
        raise RuntimeError("K3: the three-axis launch differs from three "
                           "per-axis launches")
    turns = [graph_ms(per_axis), graph_ms(lattice), graph_ms(lattice),
             graph_ms(per_axis)]
    return {"k3_bitwise_equal": equal,
            "per_axis_x3_ms": (turns[0] + turns[3]) / 2,
            "lattice_ms": (turns[1] + turns[2]) / 2, "turns": turns}


def main():
    smi = phase_device()
    print(json.dumps(k3_rows()), flush=True)
    if "--sass" in sys.argv:
        print(json.dumps(sass_counts()))
    print(smi)


if __name__ == "__main__":
    main()
