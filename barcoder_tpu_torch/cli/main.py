"""CLI of the PyTorch port: ``python -m barcoder_tpu_torch <command> ...``.

Commands:
  targets   ↔ targets.py        (guide→genome mapping)
  design    ↔ design_guides.py  (genome-wide guide design)

Both default to ``--backend auto`` (the ``cuda`` engine, which needs a
card); ``--backend torch`` or ``oracle`` runs on the CPU. The other
workloads (count, mismatch, distill, gui) are not ported yet and run on the
JAX package: ``python -m barcoder_tpu <command> ...``.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
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
    print(f"unknown command: {cmd}\n", file=sys.stderr)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
