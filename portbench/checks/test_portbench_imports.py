"""Nothing the benchmark runs imports JAX or the JAX package. Top-level
module names are compared whole: ``barcoder_tpu_torch`` begins with
``barcoder_tpu`` and is the program under test."""

import ast
import json
import subprocess
import sys

from portbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "barcoder_tpu"}


def test_no_source_file_imports_a_forbidden_module():
    for path in sorted(spec.HERE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "barcoder_tpu_torch_probe", sys)
    assert "barcoder_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "barcoder_tpu.probe", sys)
    assert harness.forbidden_modules() == ["barcoder_tpu"]


def test_a_fresh_interpreter_running_every_cell_holds_none(tmp_path):
    """Every module of the benchmark imported, every cell run small on the
    CPU, every metric read: then ``sys.modules`` holds no forbidden name."""
    code = f"""
import json, sys, importlib
sys.path.insert(0, {str(spec.ROOT)!r})
sys.path.insert(0, {str(spec.ROOT / 'portbench' / 'checks')!r})
import pkgutil, portbench
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".checks" not in m.name:
        importlib.import_module(m.name)
from conftest import small_run, CELLS
from portbench import harness
for name in CELLS:
    assert small_run(name, seconds=0.5, traced=True)["correct"]
print(json.dumps(harness.forbidden_modules()))
"""
    env = {"BARCODER_TPU_ARTIFACTS": str(tmp_path), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_entry_point_refuses_without_a_card(tmp_path):
    """No card: exit 2 and no result line, before any input is made."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "eco-targets-resident", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_a_folder_with_only_the_benchmark_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's paths has
    no program: the run fails and prints no result."""
    import shutil

    for p in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "eco-count", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
