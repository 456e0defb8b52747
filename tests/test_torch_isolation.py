"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and it sets no process-wide torch default dtype."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    code = (
        "import sys, torch\n"
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
    for path in pkg.rglob("*.py"):
        if "build" in path.relative_to(pkg).parts:  # kernel build output
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "jutul.jl_tpu.", "jutul.jl_tpu\n",
                    "from ...jl_tpu", "from ..jl_tpu"):
            assert bad not in text, f"{path}: {bad!r}"
