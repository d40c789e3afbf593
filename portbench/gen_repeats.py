"""Seeded generator of a GC-skewed genome with planted repeats, for
configurations whose ``gc`` and ``repeats`` keys ask for them (``gen.py``
draws every base with equal chance and puts a gene across the origin of
every contig, linear ones too).

Each contig is random bases at the configuration's GC share, then the
repeats on the contig that ``repeats`` names: the last ``terminal_inverted``
bases are made the reverse complement of the first, and one block of
``rrna_block`` bases is written at each of ``rrna_starts``, reverse
complemented where its strand is -1. These sizes and starts are given at
the contig length ``at_length``; a contig cut shorter (the benchmark's CPU
checks) scales them with it. Genes are evenly spaced on alternating
strands (every third named), each ``coding_share`` of the contig's length
over the gene count long; on a circular contig the layout is shifted by
half a slot so that the last gene runs across the origin, and on a linear
one no gene wraps. Everything comes from the seed's ``genome``
stream, so a seed gives the same bytes.

Nothing here imports the program."""

from __future__ import annotations

import numpy as np

from .gen import ContigData, Gene, rng
from .reference.targets_ref import revcomp_codes


def bases(n: int, gc: float, g: np.random.Generator) -> np.ndarray:
    """``n`` base codes (A C G T = 0..3), G and C each ``gc / 2`` likely."""
    at = (1.0 - gc) / 2.0
    return g.choice(4, size=n, p=[at, gc / 2.0, gc / 2.0, at]).astype(np.uint8)


def genes(n: int, n_genes: int, tag: str, coding_share: float, circular: bool) -> list:
    """``n_genes`` genes laid out as the module docstring says; locus tags
    ``<tag><number>``, numbered from 1 with as many digits as the count."""
    length = max(60, round(coding_share * n / n_genes))
    shift = n // (2 * n_genes) if circular else 0
    width = len(str(n_genes))
    out = []
    for i in range(n_genes):
        start = (i * n) // n_genes + shift
        end = start + length
        wraps = circular and end > n
        out.append(Gene(f"{tag}{i + 1:0{width}d}", f"gen{i}" if i % 3 == 0 else None, start,
                        end - n if wraps else min(end, n), 1 if i % 2 == 0 else -1, wraps))
    return out


def plant(codes: np.ndarray, repeats: dict, gc: float, g: np.random.Generator) -> None:
    """Write the terminal inverted repeat and the rRNA copies into
    ``codes``, in place."""
    scale = len(codes) / repeats["at_length"]
    t = round(repeats["terminal_inverted"] * scale)
    if t:
        codes[len(codes) - t:] = revcomp_codes(codes[:t])
    block = bases(round(repeats["rrna_block"] * scale), gc, g)
    for start, strand in zip(repeats["rrna_starts"], repeats["rrna_strands"]):
        at = round(start * scale)
        codes[at:at + len(block)] = block if strand == 1 else revcomp_codes(block)


def make_genome(config: dict, seed: int) -> list:
    """Every contig of a configuration with ``gc`` and ``repeats``, from the
    seed's genome stream."""
    g = rng(seed, "genome")
    gc, repeats = config["gc"], config["repeats"]
    out = []
    for c in config["contigs"]:
        circular = c["topology"] == "circular"
        codes = bases(c["length"], gc, g)
        if c["id"] == repeats["contig"]:
            plant(codes, repeats, gc, g)
        out.append(ContigData(c["id"], codes, circular,
                              genes(c["length"], c["genes"], c["tag"], config["coding_share"],
                                    circular)))
    return out
