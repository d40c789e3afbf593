"""Scan-input preparation shared by the oracle, the JAX reference scan, and
the Pallas kernel: spacer matrices, wrap-halo scan arrays, PAM/validity masks.
"""

from __future__ import annotations

import numpy as np

from ..core.genome import Contig
from ..core.pam import pam_site_masks


def spacer_matrix(spacers: list[str]) -> np.ndarray:
    """(S, L) int8 code matrix; all spacers must share one length
    (vectorized: one fixed-width bytes array + LUT, no per-row encode).
    An empty list yields a (0, 0) matrix — the engines' own S == 0 guards
    handle it (raising here made those guards unreachable for list input,
    with a misleading 'uniform length' message)."""
    if not spacers:
        return np.zeros((0, 0), np.int8)
    lens = {len(s) for s in spacers}
    if len(lens) != 1:
        raise ValueError(f"spacer_matrix requires uniform length, got {sorted(lens)}")
    from ..core.encode import _LUT

    arr = np.array(list(spacers), dtype="S")
    mat = arr.view(np.uint8).reshape(len(spacers), -1)
    return _LUT[mat]


def revcomp_matrix(mat: np.ndarray) -> np.ndarray:
    """(S, L) → (S, L) reverse complement of every row (vectorized — the
    design workload passes ~10^6 rows)."""
    from ..core.encode import _COMP

    return np.ascontiguousarray(_COMP[np.asarray(mat, dtype=np.int8)][:, ::-1])


def build_scan_array(contig: Contig, L: int) -> np.ndarray:
    """Genome codes extended with an (L-1)-base wrap halo for circular
    contigs, so every canonical start p in [0, len) sees a full window.

    This replaces the reference's 100 kb topological overhang
    (targets.py:35-56) with the minimal exact halo; duplicate-hit folding
    becomes unnecessary because starts >= len are never scanned.
    """
    if contig.circular and L > 1:
        halo = contig.fetch_codes(contig.length, contig.length + L - 1)
        return np.concatenate([contig.codes, halo])
    return contig.codes


def site_masks(contig: Contig, L: int, pam: str, pam_direction: str) -> tuple[np.ndarray, np.ndarray]:
    """(mask_f, mask_r) over canonical starts [0, len): PAM-compatible and
    window-valid positions per strand."""
    return pam_site_masks(contig, L, pam, pam_direction)


def enumerate_sites(
    contig: Contig, L: int, pam: str, pam_direction: str
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All PAM-valid windows of a contig as an explicit site table:
    (positions int32 (n,), strands int8 (n,), codes (n, L) int8).

    R-strand rows carry the REVERSE-COMPLEMENTED window codes, so a forward
    spacer matrix scores both strands directly (Hamming distance is
    preserved under revcomp of both operands). Windows containing N are
    KEPT — they are still PAM-valid genomic sites reachable at v >= #N
    (the one-hot matmul gives an N position zero score, exactly the dense
    kernel's semantics).

    This is the site-compacted scan's genome side (see
    pallas_scan._SiteScanJob): for an |PAM|-constrained scan every hit lies
    at one of these sites, so the scan contracts the genome axis from
    contig.length to n_sites (~N/8 for NGG) with no gather on device."""
    from ..core.encode import _COMP
    from .types import STRAND_F, STRAND_R

    scan = build_scan_array(contig, L)
    if len(scan) < L:
        # a contig shorter than the window (linear, or tiny circular with
        # L <= 1): no sites — sliding_window_view would raise, breaking
        # the shared backend contract (oracle/jax return empty here)
        return (
            np.zeros(0, np.int32), np.zeros(0, np.int8),
            np.zeros((0, L), np.int8),
        )
    windows = np.lib.stride_tricks.sliding_window_view(scan, L)[: contig.length]
    mask_f, mask_r = site_masks(contig, L, pam, pam_direction)
    mask_f = mask_f[: len(windows)]
    mask_r = mask_r[: len(windows)]
    pos_f = np.nonzero(mask_f)[0].astype(np.int32)
    pos_r = np.nonzero(mask_r)[0].astype(np.int32)
    codes_f = np.ascontiguousarray(windows[pos_f])
    codes_r = np.ascontiguousarray(_COMP[windows[pos_r]][:, ::-1])
    positions = np.concatenate([pos_f, pos_r])
    strands = np.concatenate(
        [np.full(len(pos_f), STRAND_F, np.int8), np.full(len(pos_r), STRAND_R, np.int8)]
    )
    codes = (
        np.concatenate([codes_f, codes_r])
        if len(positions)
        else np.zeros((0, L), np.int8)
    )
    return positions, strands, codes
