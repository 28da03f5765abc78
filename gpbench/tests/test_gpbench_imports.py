"""Nothing the benchmark runs loads JAX or gp_tpu (top-level names
compared whole: gp_tpu_torch is not gp_tpu), the reference imports
nothing of the program, and no code reads the JAX package's harness."""

import ast
import json
import subprocess
import sys

import pytest

from gpbench.harness import FORBIDDEN

from .shared import ROOT, STREAM_MIN_N, SMALL

PY = sorted(p for p in (ROOT / "gpbench").rglob("*.py")
            if "tests" not in p.parts)


def _imports(path):
    """The top-level names a source file (or a parsed module) imports."""
    tree = path if isinstance(path, ast.AST) else ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", PY, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    assert not _imports(path) & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "gpbench" / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "torch", "numpy"}


FAMILY_CHILD = """
import json, sys
import torch
from gpbench import harness
from gpbench.synth import make_data
cfg = harness.load_json("gpbench/configs/{config}.json")
fam = harness.family(".", "{config}", cfg)
ref = fam.Reference(cfg)
X, y = make_data(40, cfg["d"], 1)
x, yv = torch.as_tensor(X), torch.as_tensor(y)
h = ref.default_hyp(x, yv)
ref.nll_grad(x, ref.standardized(yv)[0], h, "float64")
ref.predict_with_grad(ref.posterior(x, yv, h, "float64"), x[:3], "float64")
fam.fit_eval_flops(cfg), fam.predict_request_flops(cfg, 3)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("config", ["bundled_8k", "stream_51k"])
def test_a_familys_reference_and_counts_load_nothing_of_the_program(config):
    """The family file imports the program only to build a model: at its
    top level nothing of it, and its reference and counts run without
    it, in a fresh process."""
    fam = json.loads((ROOT / "gpbench" / "configs"
                      / f"{config}.json").read_text())["family"]
    tree = ast.parse((ROOT / "gpbench" / "families"
                      / f"{fam}.py").read_text())
    top = _imports(ast.Module(body=[n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom))], type_ignores=[]))
    assert top <= {"__future__", "typing", "math", "torch", "numpy",
                   "gpbench"}
    out = subprocess.run([sys.executable, "-c",
                          FAMILY_CHILD.format(config=config)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gpbench" in loaded
    assert not loaded & {"gp_tpu_torch", *FORBIDDEN}


@pytest.mark.parametrize("path", PY, ids=lambda p: p.name)
def test_no_code_names_the_jax_harness(path):
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            assert not any(s in node.value for s in
                           ("benchmarks/", "bench.py", "chip_smoke"))


CHILD = """
import json, sys
from gp_tpu_torch.models import exact
exact._STREAM_MIN_N = {min_n}
from gpbench import harness
for wl, ov in json.loads(sys.argv[1]).items():
    harness.run(".", wl, 11, 0.2, wl.endswith("bo"), "cpu", overrides=ov)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    """Every cell, shrunk, in a fresh process: the modules it loaded."""
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(min_n=STREAM_MIN_N),
         json.dumps(SMALL)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gp_tpu_torch" in loaded and not loaded & set(FORBIDDEN)
