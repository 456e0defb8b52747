"""K8/K9 (csrc/level_kernels.cu) on the card: bitwise against the chains
they replace, then timed per level and hook beside them.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/level_resident_probe.py [--check-only]

1. builds the kernel library and prints ptxas's report for
   level_kernels.cu (registers, spills, shared memory);
2. for ragged lattices and the bench flagship's mid and coarse GMG levels,
   float32, float64 and bfloat16 coefficients, both forms where a lattice
   fits them: K8 against the K2 chain and K9 against the K4 chain (and K2's
   residual), every hook at 1, 2, 3, 5 and 12 sweeps, from zero and from u,
   with and without the residual — equal bit for bit, or it raises;
3. (unless --check-only) K8's sweep_n against its sweep count per form
   (the launch and the cost of a synchronised sweep); then on random
   diagonally dominant stencils of the flagship's mid (32, 32, 128) and
   coarse (16, 16, 64) levels and of (8, 8, 32), float32 and bfloat16
   coefficients: every hook the V-cycle calls (presmooth+residual and
   postsmooth at 2 sweeps, sweep_n at 12; Jacobi and Chebyshev) as
   CUDA-graph replays in turns (K8/K9, chain, chain, K8/K9), K10's phases
   beside them where the level routes to it, eager ms (20 calls back to
   back) of each, and the hook's bound (7 coefficient streams, b and u in
   where given, u and r out where made, once, over 3.35 TB/s), each form
   where the level fits it.
One JSON line per result; the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps  # noqa: E402
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK  # noqa: E402
from jutul.jl_tpu_torch.ops.cuda._build import load_library  # noqa: E402
from jutul.jl_tpu_torch.ops.stencil import ScalarStencil  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
OMEGA = 0.8
CHECK_L = [(16, 16, 64), (32, 32, 128), (9, 13, 37), (5, 7, 3), (2, 1, 9),
           (1, 1, 5), (17, 3, 4)]
SWEEPS = (1, 2, 3, 5, 12)
TRACE = "--trace" in sys.argv  # each case printed, then synchronised


def stencil(L, seed, dev="cuda"):
    """A diagonally dominant scalar stencil with a dead row every 11th."""
    g = torch.Generator().manual_seed(seed)
    nz, ny, nx = L
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    d = rnd(n).abs() + 6.0
    d[::11] = 0.0
    return ScalarStencil(L, d.to(dev),
                         {a: -rnd(*s).abs().to(dev)
                          for a, s in shapes.items() if all(s)},
                         {a: -rnd(*s).abs().to(dev)
                          for a, s in shapes.items() if all(s)})


def cast(A, dtype):
    return ScalarStencil(A.L, A.diag.to(dtype),
                         {a: v.to(dtype) for a, v in A.plus.items()},
                         {a: v.to(dtype) for a, v in A.minus.items()})


def k4_chain(coef, b, u, steps, n_sweep, res, L):
    mode = SK.CHEB_ZERO if u is None else SK.CHEB_FIRST
    u, d = SK.scalar_chebyshev(coef, b, u, None, steps, 0, mode, L)
    for k in range(1, n_sweep):
        u, d = SK.scalar_chebyshev(coef, b, u, d, steps, k, SK.CHEB_STEP, L)
    r = SK.scalar_jacobi(coef, b, u, 0.0, SK.MODE_RESIDUAL, L) if res \
        else None
    return u, r


def k2_chain(coef, b, u, n_sweep, res, L):
    if u is None:
        u = SK.scalar_jacobi(coef, b, None, OMEGA, SK.MODE_INIT, L)
        n_sweep -= 1
    for _ in range(n_sweep):
        u = SK.scalar_jacobi(coef, b, u, OMEGA, SK.MODE_SMOOTH, L)
    r = SK.scalar_jacobi(coef, b, u, 0.0, SK.MODE_RESIDUAL, L) if res \
        else None
    return u, r


FAILED = []


def same(what, got, want):
    """Record (and report) where ``got`` differs from its chain."""
    for g, w in zip(got, want):
        if (g is None) != (w is None) or (
                g is not None and not torch.equal(g, w)):
            diff = None if g is None or w is None else \
                float((g - w).abs().max())
            FAILED.append(what)
            if len(FAILED) <= 20:
                print(json.dumps({"differs": what, "max_abs": diff}),
                      flush=True)
            return


def check():
    n_checked = 0
    for L in CHECK_L:
        A64 = stencil(L, seed=sum(L))
        n = A64.n
        for vec, coef_dtype in ((torch.float32, None),
                                (torch.float64, None),
                                (torch.float32, torch.bfloat16)):
            A = cast(A64, vec)
            coef = SK.embed(A, coef_dtype)[2]
            g = torch.Generator(device="cuda").manual_seed(n)
            b, u = (torch.randn(n, generator=g, device="cuda", dtype=vec)
                    for _ in range(2))
            lmax = torch.tensor(2.5, dtype=vec, device="cuda")
            steps = chebyshev_steps(lmax, 0.25, max(SWEEPS))
            props = SK.device_props(b.device, vec, coef_dtype)
            for form in ("cluster", "grid"):
                plan = SK.resident_plan(L, vec, coef.dtype, props, form)
                if plan is None:
                    continue
                for u0 in (None, u):
                    for n_sweep in SWEEPS:
                        for res in (False, True):
                            tag = (f"{L} {vec} {coef_dtype} {plan} "
                                   f"from_u={u0 is not None} x{n_sweep} "
                                   f"res={res}")
                            if TRACE:
                                print(tag, flush=True)
                            same(f"K8 {tag}", SK.scalar_sweeps_resident(
                                coef, b, u0, OMEGA, n_sweep, res, L, form),
                                k2_chain(coef, b, u0, n_sweep, res, L))
                            same(f"K9 {tag}", SK.scalar_chebyshev_resident(
                                coef, b, u0, steps, n_sweep, res, L, form),
                                k4_chain(coef, b, u0, steps, n_sweep, res, L))
                            n_checked += 2
                            if TRACE:
                                torch.cuda.synchronize()
                torch.cuda.synchronize()
                print(json.dumps({"checked": [list(L), str(vec),
                                              str(coef_dtype), list(plan)]}),
                      flush=True)
    print(json.dumps({"launches_checked": n_checked,
                      "differing": len(FAILED)}), flush=True)
    if FAILED:
        raise RuntimeError(f"{len(FAILED)} launches differ from their chains")


def graph_ms(fn, reps=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    gr = torch.cuda.CUDAGraph()
    with torch.cuda.graph(gr):
        for _ in range(reps):
            fn()
    ms = eager_ms(gr.replay, reps=5) / reps
    del gr
    return ms


def eager_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def timings():
    for L in ((32, 32, 128), (16, 16, 64), (8, 8, 32)):
        A = cast(stencil(L, seed=1), torch.float32)
        n = A.n
        g = torch.Generator(device="cuda").manual_seed(2)
        b, u = (torch.randn(n, generator=g, device="cuda") for _ in range(2))
        steps = chebyshev_steps(torch.tensor(2.5, device="cuda"), 0.25, 12)
        for coef_dtype in (None, torch.bfloat16):
            csize = 2 if coef_dtype else 4
            chain = SK.ScalarLevel(A, coef_dtype=coef_dtype, resident=False,
                                   slab=False)
            slab = SK.ScalarLevel(A, coef_dtype=coef_dtype, resident=False)
            coef = chain.coef
            cheb = lambda u0, k, res: lambda form: (  # noqa: E731
                lambda: SK.scalar_chebyshev_resident(coef, b, u0, steps, k,
                                                     res, L, form))
            jac = lambda u0, k, res: lambda form: (  # noqa: E731
                lambda: SK.scalar_sweeps_resident(coef, b, u0, OMEGA, k, res,
                                                  L, form))
            # (name, K8/K9 in a form, the chain's hook, from u, residual)
            hooks = [("presmooth_residual x2", jac(None, 2, True),
                      lambda lv: lv.presmooth_residual(b, OMEGA, 2), False,
                      True),
                     ("postsmooth x2", jac(u, 2, False),
                      lambda lv: lv.postsmooth(u, b, OMEGA, 2), True, False),
                     ("sweep_n x12", jac(None, 12, False),
                      lambda lv: lv.sweep_n(b, OMEGA, 12), False, False),
                     ("presmooth_residual_cheby x2", cheb(None, 2, True),
                      lambda lv: lv.presmooth_residual_cheby(b, steps, 2),
                      False, True),
                     ("postsmooth_cheby x2", cheb(u, 2, False),
                      lambda lv: lv.postsmooth_cheby(u, b, steps, 2), True,
                      False),
                     ("sweep_n_cheby x12", cheb(None, 12, False),
                      lambda lv: lv.sweep_n_cheby(b, steps, 12), False,
                      False)]
            props = SK.device_props(b.device, torch.float32, coef_dtype)
            for form in ("cluster", "grid"):
                plan = SK.resident_plan(L, torch.float32,
                                        chain.coef.dtype, props, form)
                if plan is None:
                    continue
                for what, k_of, hook, has_u, has_r in hooks:
                    k = k_of(form)
                    turns = [graph_ms(k), graph_ms(lambda: hook(chain)),
                             graph_ms(lambda: hook(chain)), graph_ms(k)]
                    row = {"L": list(L), "coef": csize, "form": plan[0],
                           "plan": list(plan), "hook": what,
                           "graph_ms": (turns[0] + turns[3]) / 2,
                           "chain_graph_ms": (turns[1] + turns[2]) / 2,
                           "turns": turns,
                           "eager_ms": eager_ms(k),
                           "chain_eager_ms": eager_ms(lambda: hook(chain)),
                           "bound_ms": (7 * csize + 4 * (1 + has_u + 1
                                                         + has_r)) * n
                           / HBM_BYTES_PER_S * 1e3}
                    if slab.route(what.split()[0], b) == "slab":
                        row["k10_graph_ms"] = graph_ms(lambda: hook(slab))
                    print(json.dumps(row), flush=True)


def scaling():
    """Graph ms of K8's sweep_n against its sweep count, per form, float32:
    the launch (the intercept) and each synchronised sweep (the slope)."""
    for L, forms in (((16, 16, 64), ("cluster", "grid")),
                     ((32, 32, 128), ("grid",))):
        A = cast(stencil(L, seed=1), torch.float32)
        coef = SK.embed(A)[2]
        b = torch.randn(A.n, device="cuda")
        for form in forms:
            plan = SK.resident_plan(L, torch.float32, None,
                                    SK.device_props(b.device), form)

            def k8(k, form=form):
                return lambda: SK.scalar_sweeps_resident(
                    coef, b, None, OMEGA, k, False, L, form)
            row = {"L": list(L), "plan": list(plan), "graph_ms_by_sweeps": {
                k: graph_ms(k8(k)) for k in (1, 2, 3, 5, 8, 12)}}
            print(json.dumps(row), flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    lib = load_library()
    log = lib.compiler_log
    part = log[log.find("== level_kernels.cu"):] if \
        "== level_kernels.cu" in log else log
    print(part[:12000], file=sys.stderr, flush=True)
    print(json.dumps({"build_s": lib.build_seconds,
                      "props": {k: SK.device_props(
                          torch.device("cuda", 0), *k2)
                          for k, k2 in (("f32", (torch.float32, None)),
                                        ("f64", (torch.float64, None)),
                                        ("bf16c", (torch.float32,
                                                   torch.bfloat16)))}}),
          flush=True)
    check()
    if "--check-only" not in sys.argv:
        scaling()
        timings()


if __name__ == "__main__":
    main()
