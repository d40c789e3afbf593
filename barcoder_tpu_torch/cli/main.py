"""CLI of the PyTorch port: ``python -m barcoder_tpu_torch <command> ...``.

Commands map 1:1 to the JAX package's CLI and the reference's scripts:
  targets   ↔ targets.py        (guide→genome mapping)
  design    ↔ design_guides.py  (genome-wide guide design)
  count     ↔ heuristicount.py  (barcode counting in reads)
  mismatch  ↔ mismatch.py       (mismatch-efficacy model)
  distill   ↔ distillreads.py   (read sort/compress preprocessing)
  gui       ↔ extensible_GUI.py (interactive launcher: a terminal form;
                                 ``gui --graphical`` opens the PyQt5 or Tk
                                 window, whose Run spawns
                                 ``python -m barcoder_tpu_torch <argv>``)

``targets`` and ``design`` default to ``--backend auto`` (the ``cuda``
engine, which needs a card); ``--backend torch`` or ``oracle`` runs on the
CPU. ``count``'s default engine matches on the card; ``mismatch`` and
``distill`` run on the host.

Multi-host: run one process per host with the same argv and
``BARCODER_TPU_COORDINATOR=host:port`` (process 0's address),
``BARCODER_TPU_NUM_PROCESSES`` and ``BARCODER_TPU_PROCESS_ID``; the
processes join over ``torch.distributed`` (gloo) before the command runs.
``targets --backend sharded`` then scans over every process's cards,
``count`` divides the reads by chunk and ``distill --checkpoint DIR`` the
sorting, and every process prints the same output.
``BARCODER_TPU_PLATFORM=cpu`` asks for the CPU: the sharded engines' meshes
and the counters then run on CPU shards (``parallel.mesh.set_platform``).
"""

from __future__ import annotations

import os
import sys

_GUI_HELP = """usage: python -m barcoder_tpu_torch gui [--graphical | -g]

Interactive launcher for the five tools. Without a flag, a terminal form
asks for a tool and its arguments, then runs the command in this process.
--graphical (-g) opens the PyQt5 window, or the Tk one where PyQt5 is
missing; its Run button spawns `python -m barcoder_tpu_torch <argv>` and
streams the output into the window.
"""


def _apply_platform_override() -> None:
    """BARCODER_TPU_PLATFORM=cpu is the caller's request for the CPU: the
    sharded engines' default meshes and the counters' default device become
    the CPU (``parallel.mesh.set_platform``). Never a fallback: without it,
    every card engine still raises on a machine without a card."""
    platform = os.environ.get("BARCODER_TPU_PLATFORM")
    if platform:
        from ..parallel.mesh import set_platform

        set_platform(platform)


def _shield_stdout() -> None:
    """gloo can print banners straight to fd 1 from C++ when ranks connect
    (unbuffered, unscopable from Python), which would interleave with the
    CLI's machine-readable stdout. Re-point fd 1 at stderr so every native
    write lands there, and hand Python a private dup of the ORIGINAL
    stdout: the data contract (clean TSV on the process's stdout) holds.

    Idempotent: a second main() call in the same process (library/test use)
    re-enters here because multihost.initialize() returns True once
    initialized — re-shielding would dup the ALREADY-redirected fd 1 (now
    stderr) and silently send all machine-readable output to stderr."""
    global _STDOUT_SHIELDED
    if _STDOUT_SHIELDED:
        return
    sys.stdout.flush()
    real = os.dup(1)
    os.dup2(2, 1)  # native fd-1 writers (gloo) now reach stderr
    sys.stdout = os.fdopen(real, "w", buffering=1)
    _STDOUT_SHIELDED = True


_STDOUT_SHIELDED = False


def _join_cluster() -> None:
    """Multi-host runs set BARCODER_TPU_COORDINATOR / _NUM_PROCESSES /
    _PROCESS_ID (one CLI process per host); joining happens before any
    mesh is built, so every mesh spans the processes (parallel.multihost).
    No-op when the env is absent."""
    if os.environ.get("BARCODER_TPU_COORDINATOR") or os.environ.get(
        "BARCODER_TPU_NUM_PROCESSES"
    ):
        from ..parallel import multihost

        if multihost.initialize():
            _shield_stdout()


def main(argv=None) -> int:
    _apply_platform_override()
    _join_cluster()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "targets":
        from .targets import main as run

        return run(rest)
    if cmd == "design":
        from .design import main as run

        return run(rest)
    if cmd == "count":
        from .count import main as run

        return run(rest)
    if cmd == "mismatch":
        from .mismatch import main as run

        return run(rest)
    if cmd == "distill":
        from .distill import main as run

        return run(rest)
    if cmd == "gui":
        if rest and rest[0] in ("-h", "--help"):
            print(_GUI_HELP, end="")
            return 0
        from .gui import main as run

        return run(rest)
    print(f"unknown command: {cmd}\n", file=sys.stderr)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
