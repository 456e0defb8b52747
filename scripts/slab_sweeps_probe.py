"""K10 ``scalar_jacobi_slab`` (csrc/slab_kernels.cu) on the card: bitwise
against the K2 chain it replaces, then timed per level and hook beside the
chain, K8's grid form and the bound, and over a grid of tilings (the
data behind ``slab_plan``'s constants).

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/slab_sweeps_probe.py [--check-only] [--no-plans]
                                         [--plans-only]

1. builds the kernel library and prints ptxas's report for slab_kernels.cu
   (registers, spills, shared memory) on stderr;
2. on the bench flagship's fine (64, 64, 256) and mid (32, 32, 128) GMG
   levels ((nz, ny, nx)) and on ragged lattices (nx not a multiple of V, ny = 1, nz = 1,
   nz below a chunk), float32, float64 and bfloat16 coefficients: K10
   against the K2 chain for 1-4 stencil applications, from zero and from
   u, with and without the residual, with the planner's tile and with
   pinned tiles of several tiles and chunks — equal bit for bit, or it
   raises;
3. (unless --check-only) on random diagonally dominant stencils of the
   fine and mid levels, float32 and bfloat16 coefficients: the V-cycle's
   two Jacobi hooks at 2 sweeps (presmooth+residual, postsmooth) as K10
   and as the chain in turns (K10, chain, chain, K10) replayed from CUDA
   graphs, (mid) K8's grid form beside them, eager ms (20 calls
   back to back) of K10 and the chain, and the bound (7 coefficient
   streams, b and u in where given, u and r out where made, once, over
   3.35 TB/s);
4. (unless --no-plans) graph ms of K10, and of K11
   ``scalar_chebyshev_slab`` (the same kernel template with the Chebyshev
   update), over a grid of tiles (own columns ox and rows oy, chunk
   planes tz) on both levels and the V-cycle's hooks, float32;
   ``--plans-only`` runs this step alone.
One JSON line per result; the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from level_resident_probe import (  # noqa: E402
    FAILED,
    cast,
    eager_ms,
    graph_ms,
    k2_chain,
    same,
    stencil,
)

from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK  # noqa: E402
from jutul.jl_tpu_torch.ops.cuda._build import load_library  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
OMEGA = 0.8
FINE, MID = (64, 64, 256), (32, 32, 128)  # (nz, ny, nx)
CHECK_L = [MID, FINE, (9, 13, 37), (5, 1, 16), (1, 8, 32), (3, 40, 20),
           (17, 3, 4), (2, 1, 9)]
TRACE = "--trace" in sys.argv


def feasible(L, dtype, coef_dtype, napp, from_u, vec, ox, oy,
             cheby=False):
    """Does the tile (vec, ox, oy) fit a CTA (threads, shared memory)?"""
    if L[2] % vec or ox % vec:
        return False
    _, _, tx, ty = SK.slab_tile(L, napp, vec, ox, oy)
    tsize = torch.empty(0, dtype=dtype).element_size()
    csize = 2 if coef_dtype == torch.bfloat16 else tsize
    return tx // vec * ty <= SK.SLAB_THREADS and SK.slab_smem(
        tx * ty, napp, csize, tsize, from_u, cheby) <= SK.SLAB_MAX_SMEM


def pinned_plans(L, dtype, coef_dtype, napp, from_u):
    """A few tiles of several tiles and chunks (halo columns, rows and
    planes)."""
    nz, ny, nx = L
    out = []
    for vec in sorted({SK.slab_vec(nx, dtype), 1}):
        for ox, oy, tz in ((vec * max(1, nx // (3 * vec)), max(1, ny // 3),
                            max(1, nz // 3)),
                           (vec, max(1, ny // 2), 1), (nx, 1, 2)):
            if feasible(L, dtype, coef_dtype, napp, from_u, vec, ox, oy):
                out.append((vec, ox, oy, tz))
    return out


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
            for u0 in (None, u):
                for n_sweep in (1, 2, 3, 4):
                    for res in (False, True):
                        napp = SK._phase_depth(u0, n_sweep, res)
                        if napp > SK.SLAB_MAX_DEPTH:
                            continue
                        want = k2_chain(coef, b, u0, n_sweep, res, L)
                        plans = pinned_plans(L, vec, coef.dtype, napp,
                                             u0 is not None)
                        if SK.slab_plan(L, vec, coef.dtype, napp,
                                        u0 is not None) is not None:
                            plans.insert(0, None)  # the planner's tile
                        for plan in plans:
                            tag = (f"{L} {vec} {coef_dtype} plan={plan} "
                                   f"from_u={u0 is not None} x{n_sweep} "
                                   f"res={res}")
                            if TRACE:
                                print(tag, flush=True)
                            same(f"K10 {tag}", SK.scalar_jacobi_slab(
                                coef, b, u0, OMEGA, n_sweep, res, L, plan),
                                want)
                            n_checked += 1
                            if TRACE:
                                torch.cuda.synchronize()
            torch.cuda.synchronize()
            print(json.dumps({"checked": [list(L), str(vec),
                                          str(coef_dtype)]}), flush=True)
    print(json.dumps({"launches_checked": n_checked,
                      "differing": len(FAILED)}), flush=True)
    if FAILED:
        raise RuntimeError(f"{len(FAILED)} launches differ from their chains")


def _hooks(b, u):
    # (name, from u, residual, the hook on a ScalarLevel)
    return [("presmooth_residual x2", False, True,
             lambda lv: lv.presmooth_residual(b, OMEGA, 2)),
            ("postsmooth x2", True, False,
             lambda lv: lv.postsmooth(u, b, OMEGA, 2))]


def timings():
    for L in (FINE, MID):
        A = cast(stencil(L, seed=1), torch.float32)
        n = A.n
        g = torch.Generator(device="cuda").manual_seed(2)
        b, u = (torch.randn(n, generator=g, device="cuda") for _ in range(2))
        for coef_dtype in (None, torch.bfloat16):
            csize = 2 if coef_dtype else 4
            k10 = SK.ScalarLevel(A, coef_dtype=coef_dtype)
            chain = SK.ScalarLevel(A, coef_dtype=coef_dtype, resident=False,
                                   slab=False)
            props = SK.device_props(b.device, torch.float32, coef_dtype)
            grid = SK.resident_plan(L, torch.float32, k10.coef.dtype, props,
                                    "grid")
            for what, has_u, has_r, hook in _hooks(b, u):
                hname = what.split()[0]
                assert k10.route(hname, b) == "slab", (L, what)
                turns = [graph_ms(lambda: hook(k10)),
                         graph_ms(lambda: hook(chain)),
                         graph_ms(lambda: hook(chain)),
                         graph_ms(lambda: hook(k10))]
                napp = 2
                row = {"L": list(L), "coef": csize, "hook": what,
                       "plan": list(SK.slab_plan(L, torch.float32,
                                                 k10.coef.dtype, napp, has_u,
                                                 props)),
                       "graph_ms": (turns[0] + turns[3]) / 2,
                       "chain_graph_ms": (turns[1] + turns[2]) / 2,
                       "turns": turns,
                       "eager_ms": eager_ms(lambda: hook(k10)),
                       "chain_eager_ms": eager_ms(lambda: hook(chain)),
                       "bound_ms": (7 * csize + 4 * (1 + has_u + 1 + has_r))
                       * n / HBM_BYTES_PER_S * 1e3}
                if grid is not None:
                    coef = k10.coef
                    u0 = u if has_u else None
                    row["k8_grid_graph_ms"] = graph_ms(
                        lambda: SK.scalar_sweeps_resident(
                            coef, b, u0, OMEGA, 2, has_r, L, "grid"))
                print(json.dumps(row), flush=True)
        # the z-march alone: no stencil application (b and the diagonal
        # in, u out), so no halo and no sweep
        coef = SK.embed(A)[2]
        ms = graph_ms(lambda: SK.scalar_jacobi_slab(coef, b, None, OMEGA, 1,
                                                    False, L))
        print(json.dumps({"L": list(L), "stream_only_graph_ms": ms,
                          "plan": list(SK.slab_plan(L, torch.float32, None,
                                                    0, False)),
                          "bound_ms": 36 * n / HBM_BYTES_PER_S * 1e3}),
              flush=True)


def plan_grid():
    """Graph ms of K10 and K11 over tiles: the data behind the planner's
    model."""
    from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps

    for L in (FINE, MID):
        nz, ny, nx = L
        A = cast(stencil(L, seed=1), torch.float32)
        g = torch.Generator(device="cuda").manual_seed(2)
        b, u = (torch.randn(A.n, generator=g, device="cuda")
                for _ in range(2))
        coef = SK.embed(A)[2]
        steps = chebyshev_steps(torch.tensor(2.5, device="cuda"), 0.25, 2)
        for cheby in (False, True):
            for what, has_u, has_r, _ in _hooks(b, u):
                u0 = u if has_u else None
                rows = []
                for ox in sorted({nx, nx // 2, nx // 4, 32}):
                    for oy in sorted({ny // 2, ny // 4, 16, 8, 4}):
                        for tz in (1, 2, 4, 8, 12, 16):
                            if tz > nz or ox > nx or oy > ny or \
                                    not feasible(L, torch.float32,
                                                 coef.dtype, 2, has_u, 4,
                                                 ox, oy, cheby):
                                continue
                            plan = (4, ox, oy, tz)
                            ms = graph_ms(
                                lambda: SK.scalar_chebyshev_slab(
                                    coef, b, u0, steps, 2, has_r, L, plan)
                                if cheby else SK.scalar_jacobi_slab(
                                    coef, b, u0, OMEGA, 2, has_r, L, plan))
                            rows.append([ox, oy, tz, round(ms, 5)])
                rows.sort(key=lambda r: r[-1])
                print(json.dumps({"kernel": "K11" if cheby else "K10",
                                  "L": list(L), "hook": what,
                                  "planned": list(SK.slab_plan(
                                      L, torch.float32, coef.dtype, 2,
                                      has_u, cheby=cheby)),
                                  "ox_oy_tz_ms": rows}), flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    lib = load_library()
    log = lib.compiler_log
    part = log[log.find("== slab_kernels.cu"):] if \
        "== slab_kernels.cu" in log else log
    end = part.find("\n== ", 5)
    print(part[:end if end > 0 else 20000][:20000], file=sys.stderr,
          flush=True)
    print(json.dumps({"build_s": lib.build_seconds}), flush=True)
    if "--plans-only" in sys.argv:
        plan_grid()
        return
    check()
    if "--check-only" not in sys.argv:
        timings()
        if "--no-plans" not in sys.argv:
            plan_grid()


if __name__ == "__main__":
    main()
