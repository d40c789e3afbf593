"""Coordinate math on circular genomes + mismatch diff strings.

Faithful reimplementations of targets.py:184-216 (get_diff, get_coords,
get_offset, get_overlap) plus the canonical-position → reported-coordinate
fold of parse_sam_output (targets.py:380-389).
"""

from __future__ import annotations


def fold_hit_coords(p: int, L: int, chrom_length: int) -> tuple[int, int]:
    """Reported (tar_start, tar_end) for a hit starting at canonical
    position p (0 <= p < chrom_length) spanning L bases.

    Reproduces parse_sam_output: tar_start = ref_start % len,
    tar_end = ref_end % len, and when the hit wraps the origin
    (tar_end < tar_start) the start is shifted negative
    (targets.py:380-384). A hit ending exactly at the origin has
    tar_end == 0 and a negative tar_start.
    """
    a, b = fold_hit_coords_vec(p, L, chrom_length)
    return int(a), int(b)


def fold_hit_coords_vec(p, L: int, chrom_length: int):
    """Vectorized fold_hit_coords over arrays of canonical positions —
    the ONE implementation of the fold quirk (build_rows uses this
    directly; the scalar form wraps it)."""
    import numpy as np

    tar_start = p % chrom_length
    tar_end = (p + L) % chrom_length
    wrap = tar_end < tar_start
    return np.where(wrap, tar_start - chrom_length, tar_start), tar_end


def get_coords(tar_start: int, tar_end: int, chrom_length: int) -> str:
    """Circular coordinate string (targets.py:193-202)."""
    start_circular = tar_start % chrom_length
    end_circular = tar_end % chrom_length if tar_end % chrom_length != 0 else chrom_length
    if start_circular > end_circular:
        return f"({start_circular}..{chrom_length}, 0..{end_circular})"
    return f"{start_circular}..{end_circular}"


def get_offset(
    target_dir: str | None, tar_start: int, tar_end: int, feature_start: int, feature_end: int
):
    """Strand-aware distance from feature start (targets.py:205-210)."""
    if target_dir == "F":
        return tar_start - feature_start
    if target_dir == "R":
        return feature_end - tar_end
    return None


def get_overlap(tar_start: int, tar_end: int, feature_start: int, feature_end: int) -> int:
    """Interval intersection length, floored at 0 (targets.py:213-216)."""
    overlap_start = max(tar_start, feature_start)
    overlap_end = min(tar_end, feature_end)
    return overlap_end - overlap_start if overlap_start < overlap_end else 0


def get_diff(spacer: str, target: str):
    """Per-position mismatch descriptor like ``T5A,c12G``
    (targets.py:184-190; case-sensitive, so the lowercase mismatch bases of
    reconstructed targets flow through exactly as in the reference)."""
    differences = [
        f"{target_nt}{i + 1}{spacer_nt}"
        for i, (target_nt, spacer_nt) in enumerate(zip(target, spacer))
        if target_nt != spacer_nt
    ]
    return ",".join(differences) if differences else None
