"""Mismatch-efficacy linear model (reference: mismatch.py:10-111 +
mismatch_parameters.csv).

Model: y_pred(original, variant) =
    intercept + Σ_{pos mismatched} (pos_weight[pos] + sub_weight[orig→var])
    + gc_weight · GC(original)

The reference evaluates this per row in Python (mismatch.py:15-35); here the
all-single-nt-variants expansion is fully vectorized (numpy, or JAX for
device batch evaluation): for a spacer of length Lp there are 3·Lp variants
whose scores come from one broadcast add — no loops.

Grid selection semantics reproduced exactly (find_closest_mismatch,
mismatch.py:55-66): for each desired score in arange(min, max+step, step),
greedily take the unused variant with the closest score; a variant is "used"
by identity of its (position, nt) pair.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np

from ..core.encode import gc_content

NUCLEOTIDES = "ACGT"


@dataclass
class MismatchParams:
    intercept: float
    position_weights: np.ndarray  # indexed by mismatch position
    sub_weights: np.ndarray  # (4, 4) orig→var, diagonal unused
    gc_weight: float
    raw: dict

    @classmethod
    def from_csv(cls, path: str) -> "MismatchParams":
        raw: dict[str, float] = {}
        with open(path) as fh:
            for row in csv.DictReader(fh):
                raw[row["feature"]] = float(row["weight"])
        positions = sorted(int(k) for k in raw if k.isdigit())
        pos_w = np.array([raw[str(p)] for p in positions])
        sub_w = np.zeros((4, 4))
        for i, a in enumerate(NUCLEOTIDES):
            for j, b in enumerate(NUCLEOTIDES):
                if a != b:
                    sub_w[i, j] = raw.get(f"{a}{b}", 0.0)
        return cls(
            intercept=raw["intercept"],
            position_weights=pos_w,
            sub_weights=sub_w,
            gc_weight=raw["GC_content"],
            raw=raw,
        )


def calculate_y_pred(original: str, variant: str, params: MismatchParams):
    """Reference calculate_y_pred (mismatch.py:15-35): None for invalid or
    identical pairs; raises KeyError past the trained length, like the
    reference's params[f"{pos}"] lookup."""
    if original is None or variant is None:
        return None
    if not isinstance(original, str) or not isinstance(variant, str):
        return None
    if original == variant or len(original) != len(variant):
        return None
    y = params.intercept
    for pos, (a, b) in enumerate(zip(original, variant)):
        if a != b:
            if pos >= len(params.position_weights):
                raise KeyError(str(pos))
            y += params.position_weights[pos]
            sub_key = f"{a}{b}"
            if sub_key not in params.raw:
                raise KeyError(sub_key)
            y += params.raw[sub_key]
    return y + params.gc_weight * gc_content(original)


def all_single_variant_scores(spacer: str, params: MismatchParams) -> tuple[list, np.ndarray]:
    """Vectorized scores of every single-nt variant.

    Returns (variants, scores) where variants[i] = (pos, nt) in the
    reference's enumeration order (position-major, then ACGT skipping the
    original base, mismatch.py:87-99)."""
    L = len(spacer)
    if L > len(params.position_weights):
        raise KeyError(str(len(params.position_weights)))
    base = params.intercept + params.gc_weight * gc_content(spacer)
    bad = [c for c in spacer if c not in "ACGT"]
    if bad:
        # the reference crashes with KeyError('<orig><var>') the first time
        # it scores a variant at a non-ACGT position (mismatch.py:15-35);
        # silently scoring it as 'A' emitted bogus variants — raise the
        # same error class with the same key shape
        raise KeyError(f"{bad[0]}A")
    orig_idx = np.array(["ACGT".index(c) for c in spacer])
    pos_w = params.position_weights[:L]
    # (L, 4): score of mutating position p to nt b
    grid = base + pos_w[:, None] + params.sub_weights[orig_idx, :]
    variants, scores = [], []
    for p in range(L):
        for b, nt in enumerate(NUCLEOTIDES):
            if nt == spacer[p]:
                continue
            variants.append((p, nt))
            scores.append(grid[p, b])
    return variants, np.asarray(scores)


def find_closest_mismatch(score: float, variants, scores, used: set):
    """Greedy nearest unused variant (reference mismatch.py:55-66)."""
    best, best_score = None, None
    for v, s in zip(variants, scores):
        if best_score is None or abs(s - score) < abs(best_score - score):
            if v not in used:
                best, best_score = v, s
    return best, best_score


def generate_mismatches(
    spacer: str, min_score: float, max_score: float, step: float, params: MismatchParams
) -> list[tuple[tuple[int, str], float]]:
    """Pick one variant per desired-score grid point (greedy, no reuse);
    reference generate_mismatches (mismatch.py:81-111)."""
    variants, scores = all_single_variant_scores(spacer.upper(), params)
    desired = np.arange(min_score, max_score + step, step)
    chosen: list[tuple[tuple[int, str], float]] = []
    used: set = set()
    for want in desired:
        v, s = find_closest_mismatch(float(want), variants, scores, used)
        if v is not None:
            chosen.append((v, s))
            used.add(v)
    return chosen


def apply_variant(spacer: str, variant: tuple[int, str]) -> str:
    pos, nt = variant
    return spacer[:pos] + nt + spacer[pos + 1 :]


def change_description(spacer: str, variant: tuple[int, str]) -> str:
    pos, nt = variant
    return f"{spacer[pos]}{pos + 1}{nt}"
