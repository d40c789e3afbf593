"""The card's published peaks and the least time a piece of work needs.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at its full
700 W power limit: 1,979 TOP/s int8 on the tensor cores, 3.35 TB/s of HBM3.
A share of a roofline is the least time over the measured time, with the
card's power limit printed beside it (a card set below 700 W runs slower)."""

from __future__ import annotations

PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12


def least_time(ops: float, n_bytes: float) -> tuple[float, str]:
    """(seconds, what bounds them): the operations at the int8 rate or the
    bytes at the memory rate, whichever takes longer."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS, n_bytes / PEAK_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_work(spacers: int, sites: int, L: int, genome_bases: int, hits: int) -> dict:
    """The work a ``targets`` scan needs, whatever implements it: for each
    pair of a spacer and a PAM-valid site (both strands counted in
    ``sites``), 2 operations for each of the spacer's 4L one-hot rows; bytes
    are the library's and the genome's codes (one byte a base) read once and
    the hits (spacer and position as int64, strand int8, mismatches int32:
    21 bytes) written once."""
    return dict(spacers=spacers, sites=sites, pairs=spacers * sites,
                ops=2 * 4 * L * spacers * sites,
                bytes=spacers * L + genome_bases + 21 * hits)
