"""PAM pattern semantics: per-position site masks and per-hit extraction.

Reference semantics reproduced (targets.py:219-307):

  - pattern match: ``N`` is a wildcard, all other letters literal, matched
    case-insensitively against the extracted genomic window via
    ``re.match(pam.replace("N","."), extracted)`` — i.e. a *prefix* match,
    though extracted windows are exactly ``len(pam)`` long so it is an exact
    match in practice (targets.py:219-224);
  - an extraction that would run off the sequence returns None and the site
    is rejected — even for an all-N pattern (the ``if not extracted_pam``
    check precedes the all-N shortcut, targets.py:220-222);
  - window placement per (direction, strand): for a hit occupying
    [p, p+L) on the forward genome axis,

      downstream F: [p+L, p+L+|pam|)            (plus strand)
      downstream R: revcomp of [p-|pam|, p)
      upstream   F: [p-|pam|, p)
      upstream   R: revcomp of [p+L, p+L+|pam|)

  - circular contigs wrap (the reference achieves this via its 100 kb
    topological overhang; we wrap indices directly).

The *site mask* computation is vectorized over every genome position and is
what the scan kernels consume (fused hit filter); *extraction* returns the
PAM string for the report's ``pam`` column.
"""

from __future__ import annotations

import numpy as np

from .encode import N_CODE, complement_codes, decode, encode
from .genome import Contig


def pam_is_trivial(pam: str) -> bool:
    """True if the pattern imposes no constraint in reference terms: empty
    pattern → parse_sam_output never extracts (targets.py:326), so no
    filtering at all."""
    return not pam


_OOB = 5  # sentinel for out-of-bounds positions on linear contigs


def _extended_codes(codes: np.ndarray, n: int, left: int, right: int, circular: bool) -> np.ndarray:
    """codes with ``left``/``right`` halo bases: wrapped for circular,
    out-of-bounds sentinel for linear."""
    if circular:
        lh = codes[n - (left % n) :] if left else codes[:0]
        if left and len(lh) < left:  # tiny contigs
            reps = -(-left // n)
            lh = np.tile(codes, reps)[-left:]
        rh = np.tile(codes, -(-right // n))[:right] if right else codes[:0]
        return np.concatenate([lh, codes, rh])
    pad_l = np.full(left, _OOB, dtype=codes.dtype)
    pad_r = np.full(right, _OOB, dtype=codes.dtype)
    return np.concatenate([pad_l, codes, pad_r])


def _match_shifted(ext: np.ndarray, left: int, n: int, shift: int, pat_codes: np.ndarray) -> np.ndarray:
    """ok[p] = pattern matches ext at genome position p + shift, computed as
    pure shifted slices (no gathers/modulo — this runs over whole genomes)."""
    ok = np.ones(n, dtype=bool)
    for i, pc in enumerate(pat_codes):
        base = ext[left + shift + i : left + shift + i + n]
        if pc == N_CODE:
            # wildcard matches any real base (re '.' matches 'N' in the
            # reference) but never out-of-bounds
            ok &= base != _OOB
        else:
            ok &= base == pc
    return ok


def pam_site_masks(
    contig: Contig, L: int, pam: str, direction: str = "downstream"
) -> tuple[np.ndarray, np.ndarray]:
    """Boolean (ok_fwd, ok_rev) over canonical hit starts.

    For circular contigs starts span [0, len); for linear, [0, len-L]
    (arrays are still length ``len`` with the tail False).
    """
    n = contig.length
    if n == 0:
        # a zero-length circular record: the wrap arithmetic below divides
        # by n — return the same empty masks the trivial-PAM path does
        empty = np.zeros(0, dtype=bool)
        return empty, empty.copy()
    starts = np.arange(n, dtype=np.int64)
    valid_window = starts <= n - L if not contig.circular else np.ones(n, dtype=bool)
    if pam_is_trivial(pam):
        return valid_window.copy(), valid_window.copy()

    pat = encode(pam.upper())
    pat_rc = pat[::-1].copy()
    pat_rc_comp = complement_codes(pat_rc)
    m = len(pat)
    ext = _extended_codes(contig.codes, n, left=m, right=L + m, circular=contig.circular)

    if direction == "downstream":
        # F: genome[p+L : p+L+|pam|] matches pat
        ok_f = _match_shifted(ext, m, n, L, pat)
        # R: revcomp(genome[p-|pam| : p]) matches pat
        #    ⇔ genome[p-|pam|+i] == comp(pat[|pam|-1-i])
        ok_r = _match_shifted(ext, m, n, -m, pat_rc_comp)
    elif direction == "upstream":
        # F: genome[p-|pam| : p] matches pat
        ok_f = _match_shifted(ext, m, n, -m, pat)
        # R: revcomp(genome[p+L : p+L+|pam|]) matches pat
        ok_r = _match_shifted(ext, m, n, L, pat_rc_comp)
    else:
        raise ValueError(f"pam direction must be 'downstream' or 'upstream', got {direction!r}")

    return ok_f & valid_window, ok_r & valid_window


def pam_window_start(p, L: int, m: int, strand_is_rev, direction: str):
    """Start of the m-base PAM window for a hit at canonical start ``p``
    (scalar or array; ``strand_is_rev`` bool scalar or array) — the ONE
    source of truth for the reference's 4-way placement rule
    (targets.py:227-307): downstream-F p+L, downstream-R p-m,
    upstream-F p-m, upstream-R p+L. Shared by extract_pam and the
    vectorized pipeline extraction (pipeline.targets._pam_strings)."""
    if direction == "downstream":
        return np.where(strand_is_rev, p - m, p + L)
    return np.where(strand_is_rev, p + L, p - m)


def extract_pam(
    contig: Contig, p: int, L: int, strand: str, pam: str, direction: str = "downstream"
) -> str | None:
    """Extract the PAM window string for a hit at canonical start ``p``
    (reference: extract_downstream_pam / extract_upstream_pam,
    targets.py:227-307). Returns None when out of bounds on a linear contig."""
    if pam_is_trivial(pam):
        return None
    n = contig.length
    m = len(pam)

    def fetch(a: int, b: int) -> np.ndarray | None:
        if contig.circular:
            return contig.codes[np.arange(a, b) % n]
        if a < 0 or b > n:
            return None
        return contig.codes[a:b]

    start = int(pam_window_start(p, L, m, strand == "R", direction))
    window = fetch(start, start + m)
    rc = strand == "R"
    if window is None:
        return None
    if rc:
        window = complement_codes(window)[::-1]
    return decode(window)


def pam_matches(pam_pattern: str, extracted: str | None) -> bool:
    """Reference pam_matches (targets.py:219-224)."""
    if not extracted:
        return False
    if not pam_pattern or pam_pattern == "N" * len(pam_pattern):
        return True
    for pc, ec in zip(pam_pattern.upper(), extracted.upper()):
        if pc != "N" and pc != ec:
            return False
    return True
