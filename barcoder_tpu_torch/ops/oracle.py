"""Naive numpy Hamming/PAM scan — the in-repo correctness oracle.

O(S·N·L) sliding-window comparison; the ground truth every device path is
tested against (SURVEY.md §4: the reference ships no tests, so the oracle
defines expected behavior together with planted-guide property tests).

Match semantics: a base matches iff both codes are equal AND both are
A/C/G/T — genomic or spacer N never matches (Bowtie ``-v`` counts N as a
mismatch; one-hot dot products give the same result).
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from ..core.genome import Contig
from .prep import build_scan_array, revcomp_matrix, site_masks, spacer_matrix
from .types import STRAND_F, STRAND_R, Hits


def _mismatch_counts(windows: np.ndarray, q: np.ndarray) -> np.ndarray:
    """windows (P, L) vs one spacer q (L,) → (P,) mismatch counts."""
    eq = (windows == q[None, :]) & (windows < 4) & (q[None, :] < 4)
    return (~eq).sum(axis=1)


def oracle_scan(
    spacers: list[str] | np.ndarray,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
) -> Hits:
    """Scan every spacer (both strands) against one contig; return all hits
    with mismatches <= max_mismatches at PAM-compatible sites."""
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    S, L = q_f.shape
    if S == 0:
        return Hits()
    q_r = revcomp_matrix(q_f)
    scan = build_scan_array(contig, L)
    n = contig.length
    windows = sliding_window_view(scan, L)[:n] if len(scan) >= L else np.empty((0, L), scan.dtype)
    n_starts = windows.shape[0]
    mask_f, mask_r = site_masks(contig, L, pam, pam_direction)
    mask_f = mask_f[:n_starts]
    mask_r = mask_r[:n_starts]

    out = []
    for strand, q, mask in ((STRAND_F, q_f, mask_f), (STRAND_R, q_r, mask_r)):
        for i in range(S):
            mm = _mismatch_counts(windows, q[i])
            sel = (mm <= max_mismatches) & mask
            pos = np.nonzero(sel)[0]
            if len(pos):
                out.append(
                    Hits(
                        spacer_idx=np.full(len(pos), i, np.int64),
                        pos=pos.astype(np.int64),
                        strand=np.full(len(pos), strand, np.int8),
                        mismatches=mm[pos].astype(np.int32),
                    )
                )
    return Hits.concat(out).sorted()
