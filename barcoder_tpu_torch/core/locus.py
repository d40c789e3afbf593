"""Vectorized hit→gene interval join.

Replaces the reference's per-base dict lookup
(``locus_map.get((chr, pos))`` over every covered base, targets.py:412-416)
with a sorted-interval searchsorted join: entries sorted by join_start; for a
query [a, b) the candidates are entries with start in [a - max_len, b), then
exact overlap is checked. Bacterial genomes have short, sparse genes so the
candidate window stays small.

Join semantics (derived from the reference's folded-coordinate lookup):
queries use the reported hit interval [tar_start, tar_end) where tar_start
may be negative for origin-wrapping hits. Each entry exposes a *joinable*
interval [join_start, join_end): for gene bodies that is the interval
clipped to [0, len) (positions >= len are unreachable after the fold,
matching targets.py); for promoter windows (targets_in_upstream.py:47-171)
join_start may be negative, reachable by wrapped-hit queries exactly as the
reference's negative dict keys are.
"""

from __future__ import annotations

import numpy as np


class LocusIndex:
    """Sorted-interval index over a list of LocusEntry objects."""

    def __init__(self, entries):
        self.entries = entries
        js = np.array([e.join_start for e in entries], dtype=np.int64)
        je = np.array([e.join_end for e in entries], dtype=np.int64)
        keep = je > js  # drop empty (unreachable) intervals
        idx = np.nonzero(keep)[0]
        self._order = idx[np.argsort(js[idx], kind="stable")]
        self._starts = js[self._order]
        self._ends = je[self._order]
        self._max_len = int((self._ends - self._starts).max()) if len(self._order) else 0

    def join(self, tar_starts: np.ndarray, tar_ends: np.ndarray):
        """Return (hit_indices, entry_indices) for every overlapping
        (hit, entry) pair; entry indices index the original entries list."""
        tar_starts = np.asarray(tar_starts, dtype=np.int64)
        tar_ends = np.asarray(tar_ends, dtype=np.int64)
        n_hits = len(tar_starts)
        if n_hits == 0 or len(self._order) == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)

        a = tar_starts
        b = tar_ends
        lo = np.searchsorted(self._starts, a - self._max_len, side="left")
        hi = np.searchsorted(self._starts, b, side="left")
        counts = np.maximum(hi - lo, 0)
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)

        hit_idx = np.repeat(np.arange(n_hits), counts)
        offsets = np.concatenate(([0], np.cumsum(counts)))[:-1]
        within = np.arange(total) - np.repeat(offsets, counts)
        cand = np.repeat(lo, counts) + within

        keep = (self._starts[cand] < b[hit_idx]) & (self._ends[cand] > a[hit_idx])
        return hit_idx[keep], self._order[cand[keep]]


def join_hits_to_loci(contig, tar_starts, tar_ends):
    """Body-interval join against a contig (back-compat wrapper)."""
    return contig.locus_index().join(tar_starts, tar_ends)
