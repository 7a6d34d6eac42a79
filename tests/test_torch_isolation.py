"""The port stands alone: no module of ``repro_torch``, and neither
``chip_smoke.py``, ``tools/calibrate_h100.py``, ``tools/profile_torch_lm.py``
nor ``tools/time_block_ell.py``, imports JAX or the reference package
``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files, "repro_torch has no modules"
    return files + [ROOT / "chip_smoke.py", ROOT / "tools" / "calibrate_h100.py",
                    ROOT / "tools" / "profile_torch_lm.py", ROOT / "tools" / "time_block_ell.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                roots.add(arg.value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch, repro_torch.solver, repro_torch.launch.solve, "
        "repro_torch.kernels, repro_torch.sparse, repro_torch.tune, repro_torch.adaptive, "
        "repro_torch.core.models, repro_torch.serve, repro_torch.observe, "
        "repro_torch.launch.serve, repro_torch.launch.perf, repro_torch.launch.mesh, "
        "repro_torch.analysis.ecg_bench, repro_torch.launch.train, repro_torch.models.encdec, "
        "repro_torch.collectives, repro_torch.launch.dryrun, repro_torch.analysis.roofline, "
        "repro_torch.analysis.report\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
