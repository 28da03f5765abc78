"""gp_tpu_torch stands alone: it imports neither jax nor gp_tpu, and
neither does chip_smoke.py."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the package's sources; _build/ holds build output, not source
PORT_FILES = sorted(p for p in (ROOT / "gp_tpu_torch").rglob("*.py")
                    if "_build" not in p.relative_to(ROOT).parts) + [
    ROOT / "chip_smoke.py"]


def test_import_does_not_load_jax():
    code = ("import gp_tpu_torch, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not [m for m in sys.modules if m.split('.')[0] "
            "== 'gp_tpu'], 'gp_tpu imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_imports_no_jax_or_gp_tpu(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gp_tpu"), \
                f"{path.relative_to(ROOT)} imports {name}"
