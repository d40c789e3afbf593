"""``barcoder-tpu design`` — genome-wide guide designer CLI.

Argument-compatible with the reference's ``python design_guides.py``
(design_guides.py:329-404): positional genome_file, pam, barcode_length;
flags --orientation, --mismatches, --pam_direction, --omit_intergenic,
--omit_offtargets, --omit_ambiguous, --keep-top, --tile_size,
--full-overlap. TSV to stdout, logs to stderr.

The PyTorch port's copy of ``barcoder_tpu/cli/design.py``: the same
arguments, with ``--backend`` choosing among the port's scan engines
(``auto`` = ``cuda``, which needs a card; ``torch`` / ``oracle`` run on the
CPU).
"""

from __future__ import annotations

import argparse
import json
import sys

from rich.console import Console
from rich.highlighter import JSONHighlighter

from ..core.genome import Genome
from ..pipeline.design import DesignOptions, run_design
from ..utils.logger import Logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Map barcodes to a circular genome",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("genome_file", help="Path to genome file", type=str)
    p.add_argument("pam", help="PAM sequence", type=str)
    p.add_argument("barcode_length", help="Length of the barcode", type=int)
    p.add_argument(
        "--orientation", choices=["forward", "reverse", "both"], default="forward",
        help="Orientation of the barcode with respect to the gene.",
    )
    p.add_argument(
        "--mismatches", type=int, default=1, metavar="(0-2)",
        help="Number of mismatches to constitute an offtarget.",
    )
    p.add_argument(
        "--pam_direction", choices=["upstream", "downstream"], default="downstream",
        help="Direction of the PAM sequence",
    )
    p.add_argument("--omit_intergenic", action="store_true", default=True,
                   help="Omit intergenic regions")
    p.add_argument("--omit_offtargets", action="store_true", default=False,
                   help="Omit all guides that have off-targeting")
    p.add_argument("--omit_ambiguous", action="store_true", default=False,
                   help="Target only sites that have a single gene annotated.")
    p.add_argument("--keep-top", type=int, default=10, metavar="(1-n)",
                   help="Keep the top n guides for each gene")
    p.add_argument("--tile_size", type=int, default=None, metavar="(1-n)",
                   help="Tile size for the genome (defaults to barcode length)")
    p.add_argument("--full-overlap", action="store_true", default=False,
                   help="Require full overlap of the guide with the gene.")
    p.add_argument("--backend", default="auto", choices=["auto", "cuda", "sharded", "torch", "oracle"])
    p.add_argument(
        "--sgrna-out", default=None, metavar="FILE",
        help="Also write the enumerated candidate library as FASTA "
        "(name = sequence) before the off-target scan — the reference's "
        "durable sgRNA.fasta intermediate (design_guides.py:53-56,82)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    console = Console(file=sys.stderr)
    json_console = Console(file=sys.stderr, highlighter=JSONHighlighter())
    console.log("[bold red]Initializing barcode target builder[/bold red]")
    console.log("Parameters:")
    json_console.log(json.dumps({k: v for k, v in vars(args).items()}, indent=4))

    opts = DesignOptions(
        orientation=args.orientation,
        mismatches=args.mismatches,
        pam_direction=args.pam_direction,
        omit_intergenic=args.omit_intergenic,
        omit_offtargets=args.omit_offtargets,
        omit_ambiguous=args.omit_ambiguous,
        keep_top=args.keep_top,
        tile_size=args.tile_size,
        full_overlap=args.full_overlap,
    )
    log = Logger()
    # top-level user-input error contract (targets.py:703-712 applied to the
    # design script): friendly red message + exit 1, no raw traceback
    try:
        genome = Genome.load(args.genome_file)
        final, tr, candidates = run_design(
            genome, args.pam, args.barcode_length, opts, backend=args.backend,
            log=log, sgrna_out=args.sgrna_out,
        )
        if args.sgrna_out:
            console.log(f"Wrote candidate library to {args.sgrna_out}")
    except FileNotFoundError as e:
        console.log(f"[bold red]File not found[/bold red]: {e.filename or e}")
        return 1
    # no KeyError catch: the reference's design script (design_guides.py)
    # has none, and design has no user-supplied library whose attribute
    # access could raise one — an internal KeyError should traceback
    console.log(f"Found {len(tr.table):,} guides")
    final.to_csv(sys.stdout, sep="\t", index=False, na_rep="None")
    return 0


if __name__ == "__main__":
    sys.exit(main())
