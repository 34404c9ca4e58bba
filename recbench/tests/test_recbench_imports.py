"""Nothing of the benchmark imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from recbench.run import FORBIDDEN
from recbench.tests.conftest import REPO

SOURCES = sorted((REPO / "recbench").rglob("*.py"))
PORT = "transformer_recommenders_tpu_torch"


def imported(path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    resolve inside ``recbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("recbench" if node.level else node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            out |= {a.value for a in node.args if isinstance(a, ast.Constant)}
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_anywhere(path):
    tops = {m.split(".", 1)[0] for m in imported(path)}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((REPO / "recbench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_stands_alone(path):
    mods = imported(path)
    tops = {m.split(".", 1)[0] for m in mods}
    assert PORT not in tops
    assert all(m.startswith("recbench.reference") for m in mods if m.startswith("recbench"))


def test_the_names_are_compared_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "transformer_recommenders_tpu" in FORBIDDEN


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import json, pathlib, sys\n"
        f"sys.path.insert(0, {str(tiny_root)!r})\n"
        "from recbench import run\n"
        f"run.run(pathlib.Path({str(tiny_root)!r}), 'ml1m_ssm.train', 5, 0.2, False, "
        "device='cpu')\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == {PORT!r}))[:50])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout.splitlines()
    assert json.loads(out[-2]) == []
    assert PORT in out[-1]  # the run did load the port
