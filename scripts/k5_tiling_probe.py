"""Time K5 (``scalar_jacobi_phase``) under pinned tilings on a CUDA card.

    python3 scripts/k5_tiling_probe.py [--coef bf16] [--k3] [--sass]

For each level shape of the well flagship's Jacobi GMG hierarchy
((64, 64, 256), (32, 32, 128), (16, 16, 64)), float32, on a seeded
diagonally dominant stencil: the device time (CUDA-graph replay, as
chip_smoke.py ``graph_ms``) of one K5 launch at each phase depth 0-4 and
each z-chunk depth tz, the planner's choice,
and one K2 pass beside them. The per-depth slope separates what a sweep
costs from what streaming the planes costs. ``--sass`` also prints the
instruction count of each K5 and K3 kernel from cuobjdump; ``--k3`` also
times K3 on the source-term flagship (256x64x64, float32, as chip_smoke.py
``phase_kernels``): three per-axis launches against the three-axis launch,
in turns, after checking them bitwise equal.
``--coef bf16`` times the bfloat16-coefficient entries of K5 and K2 instead
(float32 vectors) and reports that entry's planner choice.
Not a check: it prints a table and the card's name and power limit.
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
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK  # noqa: E402
from jutul.jl_tpu_torch.ops.cuda._build import load_library  # noqa: E402
from jutul.jl_tpu_torch.ops.stencil import ScalarStencil  # noqa: E402

LEVELS = [(64, 64, 256), (32, 32, 128), (16, 16, 64)]
# (n_sweep, from zero, residual) giving depths 0..4
DEPTHS = {0: (1, True, False), 1: (2, True, False), 2: (2, True, True),
          3: (3, True, True), 4: (4, True, True)}


def level(L, gen, coef_dtype=None):
    nz, ny, nx = L
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.rand(*s, generator=gen, device="cuda")  # noqa: E731
    A = ScalarStencil(L, rnd(n) + 6.0, {a: -rnd(*s) for a, s in shapes.items()},
                      {a: -rnd(*s) for a, s in shapes.items()})
    return SK.ScalarLevel(A, coef_dtype=coef_dtype).coef, torch.randn(
        n, generator=gen, device="cuda")


def sass_counts():
    """Instructions per K5/K3 kernel from cuobjdump of the built library."""
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
    return {k: v for k, v in counts.items()
            if "phase" in k or "lattice" in k}


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
    turns = [graph_ms(per_axis), graph_ms(lattice), graph_ms(lattice),
             graph_ms(per_axis)]
    return {"k3_bitwise_equal": equal, "per_axis_x3_ms": (turns[0] + turns[3]) / 2,
            "lattice_ms": (turns[1] + turns[2]) / 2, "turns": turns}


def main():
    smi = phase_device()
    if "--k3" in sys.argv:
        print(json.dumps(k3_rows()), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    coef_dtype = None
    if "--coef" in sys.argv:
        name = sys.argv[sys.argv.index("--coef") + 1]
        coef_dtype = {"bf16": torch.bfloat16, "f32": None}[name]
    rows = []
    for L in LEVELS:
        coef, b = level(L, gen, coef_dtype)
        nz = L[0]
        k2 = graph_ms(lambda: SK.scalar_jacobi(coef, b, b, 0.8,
                                               SK.MODE_SMOOTH, L))
        for depth, (ns, zero, res) in DEPTHS.items():
            u = None if zero else b
            plan = SK.phase_plan(torch.float32, ns, zero, res, L,
                                 coef_dtype=coef_dtype)
            for tz in sorted({1, 2, 4, 8, 16, 32, 64, plan[0]}):
                if tz > nz:
                    continue
                ms = graph_ms(lambda: SK._launch_phase(coef, b, u, 0.8, ns,
                                                       res, L, tz))
                rows.append({"L": L, "coef": str(coef.dtype), "depth": depth,
                             "tz": tz, "ms": ms,
                             "planned": plan[0] == tz, "k2_pass_ms": k2})
                print(json.dumps(rows[-1]), flush=True)
    if "--sass" in sys.argv:
        print(json.dumps(sass_counts()))
    print(smi)


if __name__ == "__main__":
    main()
