"""What the benchmark imports: no module of ``bench/`` imports jax, jaxlib,
flax or the JAX package (top-level names compared whole, so the port's
``repro_torch`` passes), the reference and the yardstick import nothing of
the program, nothing a run loads names the JAX package's benchmark folder,
and a host with no card gets no result."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MODULES = sorted(BENCH.rglob("*.py"))
RUN_MODULES = [p for p in MODULES if not p.name.startswith("test_")]
FOREIGN = {"jax", "jaxlib", "flax", "repro"}
# modules of the yardstick, which take nothing from the program
STANDALONE = ("reference.py", "inputs.py", "yardstick.py")


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    names = top_level_imports(path)
    assert not names & FOREIGN
    assert "benchmarks" not in names


@pytest.mark.parametrize("path", RUN_MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_a_run_reads_nothing_of_the_old_benchmarks(path):
    assert "benchmarks" not in path.read_text()


def test_whole_names_are_compared(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.kernels\nfrom repro_torch import core\n")
    assert top_level_imports(src) == {"repro_torch"}
    src.write_text("import repro.core\n")
    assert top_level_imports(src) & FOREIGN == {"repro"}


@pytest.mark.parametrize("name", STANDALONE)
def test_yardstick_imports_nothing_of_the_program(name):
    names = top_level_imports(BENCH / name)
    assert "repro_torch" not in names and not names & FOREIGN
    assert names <= {"__future__", "math", "subprocess", "numpy", "torch"}


def test_configs_name_only_the_port():
    for path in (BENCH / "configs").glob("*.json"):
        module = json.loads(path.read_text())["op"]["module"]
        assert module.split(".")[0] == "repro_torch"


def test_a_host_without_a_card_gets_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path),
               TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "seismic2d-r12.shots16384-t1", "--seed", str(2**31 + 7), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "needs 1 CUDA device" in out.stderr
