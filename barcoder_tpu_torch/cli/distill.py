"""``barcoder-tpu distill`` — read sort/compress preprocessing CLI.

Argument-compatible with the reference's ``python distillreads.py R1 [R2 …]``
(distillreads.py:330-433): each input FASTQ(.gz) yields a sorted
``.reads.zst`` twin; co-indexed read tuples are sorted lexicographically
across files.
"""

from __future__ import annotations

import argparse
import sys

from ..pipeline.distill import distill_reads
from ..utils.logger import Logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sort and compress FASTQ reads")
    p.add_argument("files", nargs="+", help="FASTQ(.gz) input files (co-indexed)")
    p.add_argument("--chunk-size", type=int, default=2**20, help="Sequences per sort chunk")
    p.add_argument(
        "--checkpoint", metavar="DIR", default=None,
        help="Directory for crash-safe resume: sorted chunk runs persist "
        "there and a rerun continues from the last completed chunk",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = Logger()
    # top-level user-input error contract (reference targets.py:703-712
    # applied to the distill driver): friendly message + exit 1, never a
    # raw traceback on a missing/corrupt input
    try:
        outputs = distill_reads(
            args.files, chunk_size=args.chunk_size, log=log,
            checkpoint_dir=args.checkpoint,
        )
    except FileNotFoundError as e:
        log.error(f"File not found: {e.filename or e}")
        return 1
    except (OSError, ValueError) as e:
        # bad gzip/zstd stream, malformed FASTQ, mismatched pair lengths
        log.error(f"Could not distill reads: {e}")
        return 1
    log.info(f"Finished: {', '.join(outputs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
