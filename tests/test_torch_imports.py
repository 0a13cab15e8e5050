"""PyTorch port, import boundary: no module under src/repro_torch/ and not
chip_smoke.py imports `jax` or anything of `repro` (an AST scan; only the
parity tests import both packages), and `import repro_torch` works in a
fresh interpreter where `jax` and `repro` cannot be imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            mods.append(str(node.args[0].value))
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_repro_torch_with_jax_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch, repro_torch.core, repro_torch.data\n"
            "import repro_torch.models, repro_torch.kernels.ops\n"
            "import repro_torch.kernels.build\n"
            "import repro_torch.kernels.lsh_gather, repro_torch.kernels.adc_rank\n"
            "import repro_torch.core.probe, repro_torch.core.joins.common\n"
            "import repro_torch.core.joins.lsh, repro_torch.core.joins.ivfpq\n"
            "import repro_torch.kernels.flash_attention, repro_torch.configs\n"
            "import repro_torch.archs, repro_torch.archs.layers\n"
            "import repro_torch.archs.transformer, repro_torch.archs.spec\n"
            "import repro_torch.archs.frontends\n"
            "import repro_torch.configs.tinyllama_1_1b\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
