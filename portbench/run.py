"""One run of one benchmark cell on the card(s) of this machine:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the checks that decide ``correct`` are also the last
lines of standard error. Without enough CUDA cards it prints no result and
exits 2. ``--control`` puts the reference with one of the configuration's
guarantees broken in the program's place at the check, which must then
fail; the benchmark's own runs never pass it."""

import time

T0 = time.perf_counter()  # set-up time counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    # kernel caches at fixed paths inside the checkout, so only a checkout's
    # first run builds; the program builds its nvcc kernels into build/ there
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    # a fresh site-table store: one left on disk by an earlier run would
    # change the engine a first scan takes
    artifacts = tempfile.mkdtemp(prefix="portbench-artifacts-")
    os.environ["BARCODER_TPU_ARTIFACTS"] = artifacts
    try:
        from portbench import harness

        return harness.main(args, T0)
    finally:
        shutil.rmtree(artifacts, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
