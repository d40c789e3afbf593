"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source, ``csrc/<name>.cu`` (which may include the shared
``csrc/*.cuh`` headers), with a plain C launcher that returns the CUDA error
code. At first use it is compiled with ``nvcc`` for sm_90a into the
checkout's git-ignored ``build/barcoder_tpu_torch/<name>-<hash>.so`` (keyed
by a hash of the source, the headers and the flags, so an edit rebuilds) and
loaded with ctypes; the ptxas report (registers, shared memory, spills)
lands beside it as a ``.log`` file, and :func:`ptxas_report` reads it.
:func:`build_libraries` starts one nvcc process per missing source, all at
once, so a fresh checkout builds every kernel in the time of the slowest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

KERNELS = ("scan_hits", "scan_max", "colmax_mma", "phase1_mma", "count_match")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the kernels build into the source checkout's build/ (as
# barcoder_tpu/native_bridge.py builds its library), so the package runs from
# a checkout; an installed copy would build beside its own parent directory
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "barcoder_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_FUNCS: dict = {}


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the current build of ``csrc/<name>.cu`` lives (built or not)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_libraries(names=KERNELS) -> dict[str, Path]:
    """Compile every named kernel that has no current build, one nvcc
    process per source, all started together and all waited for; raises
    after the last one ends if any failed. Returns {name: library path}."""
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen(
            [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running.append((src, tmp, out, proc))
    failed = []
    for src, tmp, out, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
            continue
        out.with_suffix(".log").write_text(err)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def launcher(name: str, fn_name: str, argtypes: list):
    """The C launcher ``fn_name`` of kernel ``name``, built and loaded at
    first use; it returns a CUDA error code (0 = launched)."""
    fn = _FUNCS.get((name, fn_name))
    if fn is None:
        lib = ctypes.CDLL(str(build_libraries((name,))[name]))
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(name, fn_name)] = fn
    return fn


def ptxas_report(name: str) -> list[dict]:
    """Per kernel function of the current build of ``csrc/<name>.cu``: its
    (demangled where ``c++filt`` exists) name, registers and spill bytes,
    read from the ptxas log written beside the library."""
    text = library_path(name).with_suffix(".log").read_text()
    out = []
    for block in text.split("Compiling entry function '")[1:]:
        fn = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out.append(dict(function=fn, registers=int(regs.group(1)) if regs else None,
                        spill_stores=int(spill.group(1)) if spill else 0,
                        spill_loads=int(spill.group(2)) if spill else 0))
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and out:
        names = subprocess.run([cxxfilt], input="\n".join(r["function"] for r in out),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        for r, n in zip(out, names):
            r["function"] = n
    return out
