"""Import rules of the PyTorch port.

* Importing ``barcoder_tpu_torch`` and running its ``targets`` CLI (also
  with the ``sharded`` backend), its scaling harness and its experiment
  entry points leaves ``jax`` out of ``sys.modules`` (checked in a fresh
  interpreter, since this test process has imported jax already).
* The modules the port copies from the JAX package differ from their
  originals in import lines only (exact line comparison).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from barcoder_tpu.seqio.genbank import write_genbank

from .genomes import make_record, plant_guide, random_seq

REPO = Path(__file__).resolve().parent.parent

# port module -> the JAX package module it copies
COPIES = {
    "ops/types.py": "ops/types.py",
    "ops/prep.py": "ops/prep.py",
    "ops/oracle.py": "ops/oracle.py",
    "pipeline/targets.py": "pipeline/targets.py",
    "ops/__init__.py": "ops/__init__.py",
    "__main__.py": "__main__.py",
}

_PROBE = """
import json, sys
import barcoder_tpu_torch
import barcoder_tpu_torch.ops.cuda_scan, barcoder_tpu_torch.ops.scan_hits
import barcoder_tpu_torch.ops.ref_scan, barcoder_tpu_torch.cli.targets
import barcoder_tpu_torch.utils.profiling
from barcoder_tpu_torch.cli.main import main
rc = main(["targets", sys.argv[1], sys.argv[2], "NGG", "0"])
sys.stdout.flush()
print(json.dumps({"rc": rc, "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib")))}), file=sys.stderr)
"""


def test_port_and_its_cli_never_import_jax(tmp_path):
    rng = np.random.default_rng(3)
    rec = make_record(n=3000, seed=3, n_genes=4)
    g = random_seq(20, rng)
    plant_guide(rec, g, 700, pam="TGG")
    write_genbank([rec], tmp_path / "genome.gb")
    (tmp_path / "lib.fasta").write_text(f">g1\n{g}\n>miss\n{'A' * 20}\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BARCODER_TPU")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(tmp_path / "lib.fasta"),
         str(tmp_path / "genome.gb")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    assert report == {"rc": 0, "jax": []}
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("spacer\t")
    assert any(line.startswith(g) and "\t700\t" in line for line in lines[1:])


_SHARDED_PROBE = """
import io, json, sys
from contextlib import redirect_stdout
from barcoder_tpu_torch.cli.main import main
from barcoder_tpu_torch.parallel.scaling import measure_scaling
outs = []
for backend in ("torch", "sharded"):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["targets", sys.argv[1], sys.argv[2], "NGG", "0", "--backend", backend])
    outs.append((rc, buf.getvalue()))
report = measure_scaling(n_bp=4096, n_spacers=8, engine="both", device_counts=[1, 2], repeats=1)
print(outs[1][1], end="")
print(json.dumps({"rc": [rc for rc, _ in outs], "same": outs[0][1] == outs[1][1],
                  "engines": [k for k in ("flagship", "blockmax") if k in report],
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith(("jax.", "jaxlib")))}),
      file=sys.stderr)
"""


def test_sharded_backend_and_scaling_never_import_jax(tmp_path):
    """The sharded backend through the CLI, and the scaling harness, in a
    fresh interpreter: no jax, and the sharded TSV equals the torch one."""
    rng = np.random.default_rng(4)
    rec = make_record(n=5000, seed=4, n_genes=4)
    g = random_seq(20, rng)
    plant_guide(rec, g, 1900, pam="AGG", strand="R")
    write_genbank([rec], tmp_path / "genome.gb")
    (tmp_path / "lib.fasta").write_text(f">g1\n{g}\n>miss\n{'C' * 20}\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BARCODER_TPU")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SHARDED_PROBE, str(tmp_path / "lib.fasta"),
         str(tmp_path / "genome.gb")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    assert report == {"rc": [0, 0], "same": True, "engines": ["flagship", "blockmax"],
                      "jax": []}
    assert any(line.startswith(g) and "\t1900\t" in line for line in proc.stdout.splitlines())


_EXPERIMENTS_PROBE = """
import json, sys
import torch
import barcoder_tpu_torch.ops.colmax_mma, barcoder_tpu_torch.ops.phase1_variants
from barcoder_tpu_torch.experiments import int8_bench, phase1_ablate, phase1_bench
torch.cuda.is_available = lambda: False
refused = []
for mod in (int8_bench, phase1_ablate, phase1_bench):
    try:
        mod.main([])
    except SystemExit as e:
        refused.append("needs a CUDA device" in str(e))
print(json.dumps({"refused": refused, "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib")))}))
"""


def test_experiments_never_import_jax():
    """The experiment entry points and their kernel wrappers, in a fresh
    interpreter: no jax, and each entry point refuses to run without CUDA."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BARCODER_TPU")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _EXPERIMENTS_PROBE], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"refused": [True] * 3,
                                                                "jax": []}


def _without_imports(path: Path) -> list[str]:
    """Source lines of a module, less every line of an import statement."""
    src = path.read_text()
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [line for i, line in enumerate(src.splitlines(), 1) if i not in drop]


@pytest.mark.parametrize("port,original", sorted(COPIES.items()))
def test_copied_modules_differ_only_in_imports(port, original):
    got = _without_imports(REPO / "barcoder_tpu_torch" / port)
    want = _without_imports(REPO / "barcoder_tpu" / original)
    assert got == want
