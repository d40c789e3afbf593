"""``python -m barcoder_tpu_torch targets`` — CLI frontend for guide→genome
mapping on the PyTorch port.

Argument-compatible with the reference's ``python targets.py`` CLI
(targets.py:864-883): positional sgrna_file, genome_file, pam, mismatches;
``--pam_direction {upstream,downstream}``; ``--json``. TSV/JSON goes to
stdout; a rich summary table goes to stderr (targets.py:716-861).

Additions over the reference: ``--backend`` to pick the scan engine (cuda,
sharded, torch, oracle) and ``--library-column`` for TSV libraries.
"""

from __future__ import annotations

import argparse
import os
import platform
import sys
import time
from datetime import datetime

import rich.table
from rich.console import Console
from rich.table import Table

from ..pipeline.targets import TargetsResult, run_targets, write_output
from ..seqio.library import BarcodeLibrary, BarcodeLibraryError
from ..core.genome import Genome


def build_parser(parser: argparse.ArgumentParser | None = None) -> argparse.ArgumentParser:
    p = parser or argparse.ArgumentParser(description="Map barcodes to a circular genome")
    p.add_argument("sgrna_file", help="Path to sgRNA FASTA/TSV/FASTQ file", type=str)
    p.add_argument("genome_file", help="Path to genome GenBank/SnapGene/FASTA file", type=str)
    p.add_argument("pam", help="PAM sequence", type=str)
    p.add_argument("mismatches", help="Number of allowed mismatches", type=int)
    p.add_argument(
        "--pam_direction",
        choices=["upstream", "downstream"],
        default="downstream",
        help="Direction of the PAM sequence",
    )
    p.add_argument("--json", action="store_true", default=False, help="Output results in JSON format")
    p.add_argument(
        "--gene_window", choices=["body", "upstream"], default="body",
        help="Join hits to gene bodies (targets.py) or promoter windows "
        "(targets_in_upstream.py equivalent)",
    )
    p.add_argument(
        "--insert-site", action="store_true", default=False,
        help="Add CRISPRt transposon insertion-site columns "
        "(insertCharacteristics.py equivalent)",
    )
    p.add_argument(
        "--compat-columns", action="store_true", default=False,
        help="With --insert-site: emit the reference insertCharacteristics "
        "header verbatim (chrom/CRISPRtTarget/targStart/targEnd/targDir, "
        "no sp_dir) instead of the unified targets schema",
    )
    p.add_argument(
        "--max-sites", type=int, default=None, metavar="N",
        help="Bowtie-parity reporting cap: keep each spacer's best N sites "
        "genome-wide (the reference's bowtie -k 100, targets.py:502). "
        "Default: report ALL hits. Pass 100 for apples-to-apples diffs "
        "against real Bowtie output on dense-hit libraries",
    )
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "sharded", "torch", "oracle"])
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="Write a torch.profiler trace, phase timings and spans to DIR",
    )
    p.add_argument("--library-column", default="spacer", help="Barcode column for TSV libraries")
    return p


def summary_table(args, result: TargetsResult) -> Table:
    """The reference's combined rich summary table (targets.py:716-861)."""
    s = result.stats
    t = Table(
        box=rich.table.box.SIMPLE_HEAVY,
        caption=f"Finished at [u]{datetime.now()}[/u]",
        title_style="bold bright_white",
        caption_style="bold white",
        header_style="bold bright_white",
        border_style="bold bright_white",
        show_header=True,
    )
    t.add_column(os.path.basename(sys.argv[0]) or "targets", justify="right", style="white", min_width=30)
    t.add_column("Summary", justify="right", style="bold bright_white", min_width=20)

    t.add_section()
    t.add_row("[bold bright_magenta]Input & Config[/bold bright_magenta]", "")
    t.add_row("Barcodes", f"[bold]{os.path.basename(args.sgrna_file)}[/bold]")
    t.add_row("Genome File", f"[bold]{os.path.basename(args.genome_file)}[/bold]")
    t.add_row("PAM", f"[bold]{args.pam}[/bold]")
    t.add_row("PAM Direction", f"[bold]{args.pam_direction.capitalize()}[/bold]")
    t.add_row("Number of Mismatches", f"[bold]{args.mismatches}[/bold]")
    t.add_row("Backend", f"[bold]{args.backend}[/bold]")
    t.add_row("Operating System", f"[bold]{platform.system()}[/bold]")

    t.add_section()
    t.add_row("[bold bright_blue]Heuristics[/bold bright_blue]", "")
    t.add_row("Spacer Lengths", f"[bold]{s['spacer_len_range']}[/bold]")
    if s.get("systematic_name"):
        t.add_row("Systematic Name", f"[bold]{s['systematic_name']}[/bold]")
    organisms = s["organisms"]
    t.add_row(
        "Organism",
        f"[bold]{', '.join(organisms) if organisms else 'Unknown'}[/bold]",
    )
    t.add_row("Topology", f"[bold]{', '.join(s['topologies'])}[/bold]")
    t.add_row(
        "Sequence Length",
        f"[bold]{'; '.join(format(x, ',') for x in s['seq_lens'])}[/bold]",
    )
    t.add_row("Chromosomes", f"[bold]{s['chromosomes']}[/bold]")
    t.add_row("Total Genes", f"[bold]{s['total_genes']:,}[/bold]")
    t.add_row("Overlapping Genes", f"[bold]{s['overlapping_genes']:,}[/bold]")
    t.add_row("Ambiguous Coordinates", f"[bold]{s['ambiguous_coordinates']:,}[/bold]")

    t.add_section()
    t.add_row("[bold bright_green]Barcode Mapping Stats[/bold bright_green]", "")
    t.add_row("Chromosomes Targeted", f"[bold]{s['chromosomes_targeted']:,}[/bold]")
    t.add_row("Genes Targeted", f"[bold]{s['genes_targeted']:,}[/bold]")
    t.add_row("Overlapping Genes Targeted", f"[bold]{s['overlapping_genes_targeted']:,}[/bold]")
    t.add_row("Unique Barcodes", f"[bold]{s['unique_barcodes']:,}[/bold]")
    for mm, count in sorted(s.get("spacers_per_mismatch", {}).items()):
        t.add_row(f"{mm} Mismatch Barcodes", f"[bold]{count:,}[/bold]")
    t.add_row("Intergenic Barcodes", f"[bold]{s['intergenic_barcodes']:,}[/bold]")
    t.add_row("Off-targeting Barcodes", f"[bold]{s['off_target_barcodes']:,}[/bold]")
    t.add_row("Non-targeting Barcodes", f"[bold]{s['non_targeting_barcodes']:,}[/bold]")
    return t


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.compat_columns and not args.insert_site:
        parser.error("--compat-columns requires --insert-site (it renames the "
                     "insertCharacteristics columns, which only exist there)")
    console = Console(file=sys.stderr)
    console.log("[bold red]Initializing barcode target seeker[/bold red]")

    # top-level user-input error contract (targets.py:703-712): a friendly
    # red message + exit 1, never a raw traceback. The reference's
    # FileNotFoundError text blames its Bowtie subprocess; with no external
    # aligner the honest adaptation names the missing file instead.
    try:
        console.log("Loading barcode library...")
        try:
            library = BarcodeLibrary.load(args.sgrna_file, column=args.library_column)
        except KeyError as e:
            # the reference's KeyError catch (targets.py:708-712) exists for
            # its pandas library-attribute access; scope ours to the library
            # load so an internal KeyError bug in the scan/postprocess paths
            # tracebacks instead of masquerading as a user-input problem
            console.log(
                "[bold red]All of the proposed barcodes are missing some key "
                f"attributes[/bold red]: {e}"
            )
            return 1

        console.log("Loading genome and annotations...")
        genome = Genome.load(args.genome_file)

        from ..utils.profiling import Phases, device_trace, dump_spans, dump_summary

        phases = Phases()
        console.log("Scanning genome on device...")
        t0_ns = time.time_ns()
        with device_trace(args.profile):
            result = run_targets(
                library,
                genome,
                args.pam,
                args.mismatches,
                pam_direction=args.pam_direction,
                backend=args.backend,
                gene_window=args.gene_window,
                insert_site=args.insert_site,
                phases=phases,
                compat_columns=args.compat_columns,
                max_sites=args.max_sites,
            )
        if args.profile:
            dump_summary(phases, os.path.join(args.profile, "phases.json"))
            dump_spans(os.path.join(args.profile, "spans.json"), since_ns=t0_ns)
            console.log(f"Wrote device trace, phase timings and spans to {args.profile}")

        if args.json:
            console.log("Writing to JSON...")
        else:
            console.log("Writing to TSV...")
        write_output(result, sys.stdout, as_json=args.json)
    except FileNotFoundError as e:
        console.log(f"[bold red]File not found[/bold red]: {e.filename or e}")
        return 1
    except BarcodeLibraryError as e:
        console.log(f"[bold red]Trouble loading the barcode library[/bold red]: {e}")
        return 1

    console.log(summary_table(args, result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
