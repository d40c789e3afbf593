"""Minimal SAM writer/reader — the interop surface with SAM-consuming
tooling (SURVEY.md §2 native-replacement table).

The reference pipes Bowtie's SAM into pysam (targets.py:522) and its class
layer distills each record to an interval row (PySamParser.py:21-52):
Chromosome/Start/End/Mapped/Strand/Barcode/Mismatches, where Barcode is the
ORIGINAL query orientation (reverse-strand records are reverse-complemented
back, PySamParser.py:28-35) and Mismatches is the NM tag. This module emits
and parses exactly that dialect from/to ``ScanRunner.align`` frames, so a
scan can be exported for external SAM tooling and round-tripped losslessly.

Field conventions (matching what Bowtie 1 emits for end-to-end hits):
FLAG 0/16/4 (fwd/rev/unmapped), 1-based POS, MAPQ 255, CIGAR ``<L>M``,
SEQ in reference-forward orientation, QUAL Q40 (``I``) like the fake-FASTQ
bridge (targets.py:59-73), ``NM:i:<mismatches>``.
"""

from __future__ import annotations

from typing import Iterable, TextIO

import pandas as pd

from ..core.encode import revcomp

_Q40 = "I"


def write_sam(
    frame: pd.DataFrame,
    out: TextIO,
    seq_lens: dict[str, int] | None = None,
    program: str = "barcoder_tpu",
) -> None:
    """Write an align frame (ScanRunner.align schema) as SAM.

    seq_lens supplies the @SQ headers ({contig_id: length}); when absent,
    headers cover the chromosomes present in the frame with LN:0 (callers
    with a Genome should pass ``genome.seq_lens``)."""
    out.write("@HD\tVN:1.6\tSO:unsorted\n")
    if seq_lens is None:
        seq_lens = {c: 0 for c in frame.Chromosome.dropna().unique()}
    for chrom, ln in seq_lens.items():
        out.write(f"@SQ\tSN:{chrom}\tLN:{int(ln)}\n")
    out.write(f"@PG\tID:{program}\tPN:{program}\n")
    for row in frame.itertuples(index=False):
        barcode = row.Barcode
        if getattr(row, "Mapped", False):
            flag = 16 if row.Strand == "-" else 0
            seq = revcomp(barcode) if flag == 16 else barcode
            out.write(
                "\t".join(
                    (
                        barcode,
                        str(flag),
                        str(row.Chromosome),
                        str(int(row.Start) + 1),
                        "255",
                        f"{len(barcode)}M",
                        "*",
                        "0",
                        "0",
                        seq,
                        _Q40 * len(barcode),
                        f"NM:i:{int(row.Mismatches)}",
                    )
                )
                + "\n"
            )
        else:
            out.write(
                "\t".join(
                    (barcode, "4", "*", "0", "0", "*", "*", "0", "0",
                     barcode, _Q40 * len(barcode))
                )
                + "\n"
            )


def iter_sam(lines: Iterable[str]):
    """Yield (qname, flag, rname, pos0, seq, nm) per alignment line.
    Blank lines are skipped (file iteration yields '\\n', which is truthy);
    lines with fewer than the 11 mandatory SAM fields raise a clear
    ValueError instead of an opaque IndexError."""
    for line in lines:
        if not line.strip() or line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 11:
            raise ValueError(
                f"malformed SAM line ({len(f)} fields, need >= 11): "
                f"{line[:80]!r}"
            )
        qname, flag, rname, pos = f[0], int(f[1]), f[2], int(f[3])
        seq = f[9]
        nm = 0
        for tag in f[11:]:
            if tag.startswith("NM:i:"):
                nm = int(tag[5:])
                break
        yield qname, flag, rname, pos - 1, seq, nm


def parse_sam(lines: Iterable[str]) -> pd.DataFrame:
    """SAM → the reference's interval-frame schema (PySamParser.py:21-52):
    reverse-strand sequences are reverse-complemented back to the original
    query orientation; Mismatches is the NM tag (0 when absent)."""
    data = []
    for qname, flag, rname, pos0, seq, nm in iter_sam(lines):
        unmapped = bool(flag & 4)
        reverse = bool(flag & 16)
        strand = "." if unmapped else ("-" if reverse else "+")
        data.append(
            {
                "Chromosome": None if unmapped else rname,
                "Start": -1 if unmapped else pos0,
                "End": -1 if unmapped else pos0 + len(seq),
                "Mapped": not unmapped,
                "Strand": strand,
                "Barcode": revcomp(seq) if reverse else seq,
                "Mismatches": nm,
            }
        )
    # explicit columns so a header-only SAM (e.g. an empty library round
    # trip) keeps the documented schema instead of a columnless frame
    return pd.DataFrame(
        data,
        columns=[
            "Chromosome", "Start", "End", "Mapped", "Strand", "Barcode",
            "Mismatches",
        ],
    )
