"""Import rules of the PyTorch port.

* Importing ``barcoder_tpu_torch`` and running its ``targets``,
  ``design``, ``count``, ``mismatch``, ``distill`` and ``gui --help`` CLIs,
  its class API, ``run_count`` with the device engine on the CPU and with
  the sharded engine over two processes (``parallel.multihost``,
  ``parallel.sharded_count``), its sharded engine (``sharded_scan_contigs``,
  ``sharded_scan_many``) on a CPU mesh, its scaling harness, its graft
  twin and its experiment entry points leaves ``jax`` and every module of
  the JAX package ``barcoder_tpu`` out of ``sys.modules`` (checked in
  fresh interpreters, since this test process has imported both already).
* No import statement of the port or of ``chip_smoke.py``, at module level
  or inside a function, names ``barcoder_tpu``, ``jax`` or ``tests`` (whose
  helpers import the JAX package).
* The modules the port copies from the JAX package differ from their
  originals in import lines only (exact line comparison), and the port's
  ``dump_summary`` is a verbatim copy. Its partial copies
  (``pipeline/heuristic_count.py``, ``pipeline/distill.py``,
  ``pipeline/targets.py``, ``pipeline/design.py``: their entry points
  record the port's spans) share every top-level definition with their
  originals but a named few, as many as each entry states, and its GUI
  launchers (``cli/gui_qt.py``, ``cli/gui_tk.py``) differ from theirs only
  in the package their Run button spawns.
"""

import ast
import inspect
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
    "ops/__init__.py": "ops/__init__.py",
    "__main__.py": "__main__.py",
    "utils/artifacts.py": "utils/artifacts.py",
    "utils/logger.py": "utils/logger.py",
    "api.py": "api.py",
    "native_bridge.py": "native_bridge.py",
    "cli/count.py": "cli/count.py",
    "cli/mismatch.py": "cli/mismatch.py",
    "cli/distill.py": "cli/distill.py",
    "model/__init__.py": "model/__init__.py",
    "model/mismatch.py": "model/mismatch.py",
    "cli/gui.py": "cli/gui.py",
    **{f"core/{m}.py": f"core/{m}.py"
       for m in ("__init__", "encode", "genome", "pam", "coords", "locus")},
    **{f"seqio/{m}.py": f"seqio/{m}.py"
       for m in ("__init__", "genbank", "fasta", "snapgene", "library", "sam", "fast_reader")},
}

# port module -> (the JAX package module it copies in part, the top-level
# definitions that differ, how many other definitions the two share by
# name): every one of those is source-equal
PARTIAL_COPIES = {
    "pipeline/heuristic_count.py": ("pipeline/heuristic_count.py",
                                    {"run_count", "_stream_counts"}, 23),
    "pipeline/distill.py": ("pipeline/distill.py", {"distill_reads", "_distill_multihost"}, 13),
    "pipeline/targets.py": ("pipeline/targets.py",
                            {"run_targets", "build_rows", "postprocess", "_summary_stats"}, 5),
    "pipeline/design.py": ("pipeline/design.py", {"run_design", "apply_design_filters"}, 5),
}

# port module -> the JAX package module it copies with the package it
# spawns (``python -m barcoder_tpu``) renamed, and nothing else
SPAWN_COPIES = {
    "cli/gui_qt.py": "cli/gui_qt.py",
    "cli/gui_tk.py": "cli/gui_tk.py",
}

# what a fresh interpreter reports after running the port: every loaded
# module of jax or of the JAX package
_LOADED = """sorted(m for m in sys.modules if m in ("jax", "barcoder_tpu")
                 or m.startswith(("jax.", "jaxlib", "barcoder_tpu.")))"""

_PROBE = """
import json, sys
import barcoder_tpu_torch
import barcoder_tpu_torch.ops.cuda_scan, barcoder_tpu_torch.ops.scan_hits
import barcoder_tpu_torch.ops.ref_scan, barcoder_tpu_torch.cli.targets
import barcoder_tpu_torch.utils.profiling
from barcoder_tpu_torch.cli.main import main
rc = main(["targets", sys.argv[1], sys.argv[2], "NGG", "0", "--backend", "torch"])
sys.stdout.flush()
print(json.dumps({"rc": rc, "jax": %s}), file=sys.stderr)
""" % _LOADED


def _probe_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BARCODER_TPU")}
    env["PYTHONPATH"] = str(REPO)
    env["BARCODER_TPU_ARTIFACTS"] = str(tmp_path / "artifacts")
    return env


def test_port_and_its_cli_never_import_jax(tmp_path):
    rng = np.random.default_rng(3)
    rec = make_record(n=3000, seed=3, n_genes=4)
    g = random_seq(20, rng)
    plant_guide(rec, g, 700, pam="TGG")
    write_genbank([rec], tmp_path / "genome.gb")
    (tmp_path / "lib.fasta").write_text(f">g1\n{g}\n>miss\n{'A' * 20}\n")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(tmp_path / "lib.fasta"),
         str(tmp_path / "genome.gb")],
        capture_output=True, text=True, env=_probe_env(tmp_path), cwd=tmp_path, timeout=240,
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
import torch
from barcoder_tpu_torch.cli.main import main
from barcoder_tpu_torch.core.genome import Genome
from barcoder_tpu_torch.ops.scan import scan_contigs
from barcoder_tpu_torch.parallel.mesh import make_mesh
from barcoder_tpu_torch.parallel.scaling import measure_scaling
from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan_contigs, sharded_scan_many
from barcoder_tpu_torch.seqio.library import BarcodeLibrary
cpu = torch.device("cpu")
buf = io.StringIO()
with redirect_stdout(buf):
    rc = main(["targets", sys.argv[1], sys.argv[2], "NGG", "0", "--backend", "torch"])
print(buf.getvalue(), end="")
contigs = Genome.load(sys.argv[2]).contigs
spacers = [s for _, s in BarcodeLibrary.load(sys.argv[1]).entries]
key = lambda h: list(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist()))
want = [key(h) for h in scan_contigs(spacers, contigs, 1, "NGG", backend="torch")]
mesh = make_mesh(devices=[cpu] * 4)
same = [key(h) for h in sharded_scan_contigs(spacers, contigs, 1, "NGG", mesh=mesh,
                                             P=1024)] == want
many = sharded_scan_many([spacers, spacers[:1]], contigs[0], 1, "NGG", mesh=mesh, P=1024)
same = same and key(many[0]) == want[0]
report = measure_scaling(n_bp=4096, n_spacers=8, engine="both", device_counts=[1, 2],
                         repeats=1, devices=[cpu])
print(json.dumps({"rc": rc, "same": same, "engines": [k for k in ("flagship", "blockmax")
                                                       if k in report], "jax": %s}),
      file=sys.stderr)
""" % _LOADED


def test_sharded_backend_and_scaling_never_import_jax(tmp_path):
    """The sharded engine (sharded_scan_contigs, sharded_scan_many) on an
    explicit CPU mesh, and the scaling harness on the CPU, in a fresh
    interpreter: no jax, and the sharded Hits equal the torch backend's."""
    rng = np.random.default_rng(4)
    rec = make_record(n=5000, seed=4, n_genes=4)
    g = random_seq(20, rng)
    plant_guide(rec, g, 1900, pam="AGG", strand="R")
    write_genbank([rec], tmp_path / "genome.gb")
    (tmp_path / "lib.fasta").write_text(f">g1\n{g}\n>miss\n{'C' * 20}\n")
    proc = subprocess.run(
        [sys.executable, "-c", _SHARDED_PROBE, str(tmp_path / "lib.fasta"),
         str(tmp_path / "genome.gb")],
        capture_output=True, text=True, env=_probe_env(tmp_path), cwd=tmp_path, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    assert report == {"rc": 0, "same": True, "engines": ["flagship", "blockmax"], "jax": []}
    assert any(line.startswith(g) and "\t1900\t" in line for line in proc.stdout.splitlines())


_DESIGN_PROBE = """
import json, sys
from barcoder_tpu_torch.cli.main import main
rc = main(["design", sys.argv[1], "NGG", "20", "--backend", "torch", "--keep-top", "2"])
sys.stdout.flush()
print(json.dumps({"rc": rc, "jax": %s}), file=sys.stderr)
""" % _LOADED


def test_design_cli_never_imports_jax(tmp_path):
    rec = make_record(n=6000, seed=24, n_genes=4)
    write_genbank([rec], tmp_path / "genome.gb")
    proc = subprocess.run(
        [sys.executable, "-m", "barcoder_tpu_torch", "design", str(tmp_path / "genome.gb"),
         "NGG", "20", "--backend", "torch"],
        capture_output=True, text=True, env=_probe_env(tmp_path), cwd=tmp_path, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("spacer\t") and len(lines) > 1
    proc = subprocess.run(
        [sys.executable, "-c", _DESIGN_PROBE, str(tmp_path / "genome.gb")],
        capture_output=True, text=True, env=_probe_env(tmp_path), cwd=tmp_path, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == {"rc": 0, "jax": []}


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
print(json.dumps({"refused": refused, "jax": %s}))
""" % _LOADED


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


_HOST_PROBE = """
import io, json, sys
from contextlib import redirect_stdout
import barcoder_tpu_torch.api
from barcoder_tpu_torch.cli.main import main
from barcoder_tpu_torch.pipeline.heuristic_count import run_count
lib, r1, r2, params, spacers = sys.argv[1:6]
doc, undoc, total, info = run_count(lib, r1, r2, engine="device", device="cpu")
buf = io.StringIO()
with redirect_stdout(buf):
    rcs = [main(["count", lib, r1, r2, "--engine", "vector"]),
           main(["mismatch", "mismatches", "--spacers_file", spacers,
                 "--parameters_file", params]),
           main(["distill", r1, r2])]
cli_counts = dict(line.split("\\t") for line in buf.getvalue().splitlines()[:len(doc)])
print(json.dumps({"rcs": rcs, "engine": info["engine"], "total": total,
                  "same": cli_counts == {k: str(v) for k, v in doc.items()},
                  "jax": %s}))
""" % _LOADED


def test_count_mismatch_distill_and_api_never_import_jax(tmp_path):
    """The class API, run_count(engine="device", device="cpu") and the
    count, mismatch and distill CLIs, in a fresh interpreter: no jax, and
    the CLI's counts equal the device engine's."""
    from .test_heuristic_count import make_barcodes, make_reads, write_reads

    barcodes = make_barcodes(n=12, seed=4)
    reads1, reads2, _ = make_reads(barcodes, n_reads=600, seed=4)
    write_reads(tmp_path / "r1.fastq", reads1)
    write_reads(tmp_path / "r2.fastq", reads2)
    (tmp_path / "lib.fasta").write_text("".join(f">{b}\n{b}\n" for b in barcodes))
    (tmp_path / "params.csv").write_text(
        "feature,weight\nintercept,0.1\n" + "".join(f"{p},0.0{p}\n" for p in range(20))
        + "".join(f"{a}{b},0.2\n" for a in "ACGT" for b in "ACGT" if a != b)
        + "GC_content,0.3\n")
    (tmp_path / "spacers.tsv").write_text("target\n" + barcodes[0] + "\n")
    args = [str(tmp_path / f) for f in ("lib.fasta", "r1.fastq", "r2.fastq", "params.csv",
                                        "spacers.tsv")]
    proc = subprocess.run([sys.executable, "-c", _HOST_PROBE, *args], capture_output=True,
                          text=True, env=_probe_env(tmp_path), cwd=tmp_path, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "rcs": [0, 0, 0], "engine": "device", "total": 600, "same": True, "jax": []}
    assert (tmp_path / "r1.reads.zst").exists() and (tmp_path / "r2.reads.zst").exists()


_MULTIHOST_PROBE = """
import io, json, sys
from contextlib import redirect_stdout
import torch
import barcoder_tpu_torch.parallel.multihost as multihost
import barcoder_tpu_torch.parallel.sharded_count
from barcoder_tpu_torch import graft_entry
from barcoder_tpu_torch.cli.main import main
from barcoder_tpu_torch.parallel.mesh import set_platform
from barcoder_tpu_torch.pipeline.heuristic_count import run_count
pid, port, lib, reads = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
buf = io.StringIO()
with redirect_stdout(buf):
    rc = main(["gui", "--help"])
fn, args = graft_entry.entry(device="cpu")
found = float(fn(*args).sum())
graft_entry.dryrun_multichip(2, device="cpu")
set_platform("cpu")
joined = multihost.initialize(f"localhost:{port}", 2, pid)
doc, undoc, total, info = run_count(lib, reads, chunk_size=256)
print(json.dumps({"rc": rc, "gui_help": "--graphical" in buf.getvalue(), "found": found,
                  "joined": joined, "engine": info["engine"], "total": total,
                  "owned": info["owned_reads"], "jax": %s}))
""" % _LOADED


def test_multihost_gui_and_graft_never_import_jax(tmp_path):
    """parallel.multihost, parallel.sharded_count, the gui command's help,
    the graft twin and a two-process (gloo) run_count, in fresh
    interpreters: no jax, and the two processes' owned reads cover the
    reads once."""
    from barcoder_tpu_torch.parallel.multihost import free_port, spawn_joined

    from .test_heuristic_count import make_barcodes, write_run_count_fastq

    barcodes = make_barcodes(n=10, seed=2)
    write_run_count_fastq(tmp_path / "reads.fastq", barcodes)
    (tmp_path / "lib.fasta").write_text("".join(f">b{i}\n{b}\n" for i, b in enumerate(barcodes)))
    port = free_port()
    runs = spawn_joined([[sys.executable, "-c", _MULTIHOST_PROBE, str(pid), str(port),
                          str(tmp_path / "lib.fasta"), str(tmp_path / "reads.fastq")]
                         for pid in range(2)], [_probe_env(tmp_path)] * 2, tmp_path, 240)
    reports = []
    for rc, stdout, stderr, _s in runs:
        assert rc == 0, stderr[-2000:]
        reports.append(json.loads(stdout.strip().splitlines()[-1]))
    for r in reports:
        assert {k: r[k] for k in ("rc", "gui_help", "joined", "engine", "total", "jax")} == {
            "rc": 0, "gui_help": True, "joined": True, "engine": "sharded", "total": 1500,
            "jax": []}
        assert r["found"] >= 4
    assert sum(r["owned"] for r in reports) == 1500 and all(r["owned"] for r in reports)


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


@pytest.mark.parametrize("port,original", sorted(SPAWN_COPIES.items()))
def test_gui_launchers_spawn_the_port(port, original):
    """The graphical launchers are the JAX package's, word for word, but
    for the module their Run button spawns."""
    got = (REPO / "barcoder_tpu_torch" / port).read_text()
    want = (REPO / "barcoder_tpu" / original).read_text()
    spawn = '[sys.executable, "-m", "barcoder_tpu", *argv]'
    assert want.count(spawn) == 1
    assert got == want.replace(spawn, spawn.replace("barcoder_tpu", "barcoder_tpu_torch")).replace(
        "``python -m barcoder_tpu <argv>``", "``python -m barcoder_tpu_torch <argv>``")


def _definitions(path: Path) -> dict[str, str]:
    """Source text of each top-level function, class and assigned name."""
    src = path.read_text()
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names = [t.id for t in targets if isinstance(t, ast.Name)]
        else:
            continue
        for name in names:
            out[name] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("port", sorted(PARTIAL_COPIES))
def test_partial_copies_share_their_definitions(port):
    original, differ, n_shared = PARTIAL_COPIES[port]
    got = _definitions(REPO / "barcoder_tpu_torch" / port)
    want = _definitions(REPO / "barcoder_tpu" / original)
    assert differ <= set(got) & set(want)
    shared = set(got) & set(want) - differ
    assert len(shared) == n_shared
    assert {name for name in shared if got[name] != want[name]} == set()
    src = (REPO / "barcoder_tpu_torch" / port).read_text()
    assert "import jax" not in src and "jax." not in src


def _imported_modules(path: Path) -> list[str]:
    """Every module an import statement of ``path`` names, at any depth,
    relative ones resolved against the file's package."""
    rel = path.relative_to(REPO).with_suffix("")
    package = list(rel.parts[:-1])  # a module's package, or an __init__'s own
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return names


_PORT_FILES = sorted(p.relative_to(REPO).as_posix()
                     for p in (REPO / "barcoder_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_port_imports_nothing_of_the_jax_package(rel):
    """Statically, at every depth: no import of barcoder_tpu (or a module
    under it), of jax, or of the tests (their helpers import the JAX
    package)."""
    bad = [m for m in _imported_modules(REPO / rel)
           if m.split(".")[0] in ("barcoder_tpu", "jax", "jaxlib", "tests")]
    assert bad == []


def test_import_scan_sees_relative_and_nested_imports(tmp_path):
    """The static scan resolves a relative import and one inside a function."""
    pkg = REPO / "barcoder_tpu_torch" / "ops"
    names = _imported_modules(pkg / "prep.py")
    assert "barcoder_tpu_torch.core.genome.Contig" in names  # module level, relative
    assert "barcoder_tpu_torch.core.encode._LUT" in names  # inside a function
    assert "barcoder_tpu_torch.seqio.genbank.write_genbank" in _imported_modules(
        REPO / "chip_smoke.py")


@pytest.mark.parametrize("name", ["dump_summary"])
def test_profiling_copies_are_verbatim(name):
    import barcoder_tpu.utils.profiling as original
    import barcoder_tpu_torch.utils.profiling as port

    assert inspect.getsource(getattr(port, name)) == inspect.getsource(getattr(original, name))
