"""The port stands alone: importing it (and building its native library)
pulls in neither JAX nor the JAX package and opens no file of the JAX
package, no port source names either, and it sets no process-wide torch
default dtype."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    code = (
        "import os, sys\n"
        # every file the port opens while it imports and builds
        f"jax_pkg = os.path.join({str(REPO)!r}, 'jutul', 'jl_tpu') + os.sep\n"
        "read = []\n"
        "sys.addaudithook(lambda ev, a: read.append(str(a[0])) if ev == "
        "'open' and isinstance(a[0], (str, bytes, os.PathLike)) else None)\n"
        "import torch\n"
        "import jutul.jl_tpu_torch\n"
        "import jutul.jl_tpu_torch.ops.cuda\n"
        "import jutul.jl_tpu_torch.simulator.simulator\n"
        "import jutul.jl_tpu_torch.ops.blockell\n"
        "import jutul.jl_tpu_torch.linsolve.amg\n"
        "import jutul.jl_tpu_torch.linsolve.cpr\n"
        "import jutul.jl_tpu_torch.linsolve.direct\n"
        "import jutul.jl_tpu_torch.linsolve.krylov\n"
        "import jutul.jl_tpu_torch.linsolve.precond\n"
        "import jutul.jl_tpu_torch.linsolve.system\n"
        "import jutul.jl_tpu_torch.linsolve.schur\n"
        "import jutul.jl_tpu_torch.multimodel.core\n"
        "import jutul.jl_tpu_torch.ops.mixed\n"
        "import jutul.jl_tpu_torch.models.test_systems\n"
        "import jutul.jl_tpu_torch.adjoint.generic\n"
        "import jutul.jl_tpu_torch.adjoint.dict_opt\n"
        "import jutul.jl_tpu_torch.simulator.io\n"
        "import jutul.jl_tpu_torch.simulator.reporting\n"
        "import jutul.jl_tpu_torch.simulator.distance_functions\n"
        "import jutul.jl_tpu_torch.simulator.convergence_monitors\n"
        "import jutul.jl_tpu_torch.simulator.timesteps\n"
        "import jutul.jl_tpu_torch.meshes.unstructured\n"
        "import jutul.jl_tpu_torch.discretization.tpfa\n"
        "import jutul.jl_tpu_torch.discretization.weno\n"
        "import jutul.jl_tpu_torch.discretization.nfvm\n"
        "import jutul.jl_tpu_torch.models.transport\n"
        "import jutul.jl_tpu_torch.models.composite\n"
        "import jutul.jl_tpu_torch.models.helper\n"
        "import jutul.jl_tpu_torch.models.vectorization\n"
        "import jutul.jl_tpu_torch.interpolation\n"
        "import jutul.jl_tpu_torch.native\n"
        "import jutul.jl_tpu_torch.parallel.partition\n"
        "import jutul.jl_tpu_torch.parallel.comm\n"
        "import jutul.jl_tpu_torch.parallel.slab\n"
        "import jutul.jl_tpu_torch.parallel.dd\n"
        "import jutul.jl_tpu_torch.parallel.sharded\n"
        "import jutul.jl_tpu_torch.parallel.adjoint\n"
        "import jutul.jl_tpu_torch.parallel.general\n"
        "import jutul.jl_tpu_torch.parallel.general_cpr\n"
        "import jutul.jl_tpu_torch.parallel.general_adjoint\n"
        "import jutul.jl_tpu_torch.meshes.coarse\n"
        "import jutul.jl_tpu_torch.meshes.convexgeom\n"
        "import jutul.jl_tpu_torch.meshes.cutcell\n"
        "import jutul.jl_tpu_torch.meshes.embedded\n"
        "import jutul.jl_tpu_torch.meshes.extruded\n"
        "import jutul.jl_tpu_torch.meshes.radial\n"
        "import jutul.jl_tpu_torch.meshes.tags\n"
        "import jutul.jl_tpu_torch.meshes.trajectories\n"
        "import jutul.jl_tpu_torch.utils.timing\n"
        "import jutul.jl_tpu_torch.utils.vtk\n"
        "import jutul.jl_tpu_torch.utils.gmsh\n"
        "import jutul.jl_tpu_torch.utils.mrst\n"
        "import jutul.jl_tpu_torch.utils.plotting\n"
        "from jutul.jl_tpu_torch.native import native_rcm\n"
        "native_rcm([[0, 1], [1, 2]], 3)\n"
        "bad = [p for p in read if os.path.abspath(p).startswith(jax_pkg)]\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'jutul.jl_tpu' not in sys.modules, 'jutul.jl_tpu imported'\n"
        "assert torch.get_default_dtype() == torch.float32\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    pkg = REPO / "jutul" / "jl_tpu_torch"
    for path in [*pkg.rglob("*.py"), *pkg.rglob("*.cpp"), *pkg.rglob("*.cu")]:
        if "build" in path.relative_to(pkg).parts:  # kernel build output
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "jutul.jl_tpu.", "jutul.jl_tpu\n",
                    "from ...jl_tpu", "from ..jl_tpu", '"jl_tpu"',
                    "'jl_tpu'"):
            assert bad not in text, f"{path}: {bad!r}"


def test_native_library_builds_from_the_ports_own_source():
    """The native source the port compiles lies inside the port, and so
    does the library it loads."""
    from jutul.jl_tpu_torch import native

    port = REPO / "jutul" / "jl_tpu_torch"
    assert native.SOURCE.resolve().is_relative_to(port)
    assert native.load_library()._name == str(native.library_path())
    assert native.library_path().resolve().is_relative_to(port / "build")
