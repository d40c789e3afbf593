"""Plain reference of a ``targets`` request: the table a user gets.

Semantics, as the configurations state them:

- a hit is a window of the spacer's length on either strand whose bases
  differ from the spacer (read on that strand) in at most ``v`` positions,
  where a base matches only an equal A, C, G or T, and whose PAM window
  matches the pattern (``N`` any base); downstream, the forward PAM is
  ``[p + L, p + L + m)`` and the reverse PAM the reverse complement of
  ``[p - m, p)``; a circular contig wraps at its origin;
- its reported coordinates are ``p mod n`` and ``(p + L) mod n``, the start
  made negative where the window crosses the origin;
- its target is the window in the spacer's orientation, mismatched bases in
  lower case; its PAM the window's PAM in the same orientation;
- it joins every gene whose part below the contig's length overlaps
  ``[tar_start, tar_end)`` (a gene across the origin joins by its part
  before the origin), with offset ``tar_start - start`` on the forward
  strand and ``end - tar_end`` on the reverse, overlap the length of the
  intersection with the whole gene, ``gene`` its name or else its locus tag;
  a hit in no gene is one intergenic row;
- a spacer with no hit is one non-targeting row;
- every row carries a note: its spacer's distinct sites, gene rows and
  intergenic rows.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

COMP = np.array([3, 2, 1, 0, 4], np.uint8)
LETTERS = np.frombuffer(b"ACGTN", np.uint8)
_CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def encode(seqs: list) -> np.ndarray:
    """(S, L) uint8 codes of equal-length spacers (A C G T = 0..3, else 4)."""
    L = len(seqs[0])
    return _CODE[np.frombuffer("".join(seqs).encode(), np.uint8).reshape(-1, L)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return COMP[codes][..., ::-1]


def pam_sites(codes: np.ndarray, circular: bool, L: int, pam: str, direction: str):
    """Window starts whose PAM matches: (forward, reverse), each sorted."""
    n = len(codes)
    pat = [None if ch == "N" else int(_CODE[ord(ch)]) for ch in pam.upper()]
    m = len(pat)
    if direction == "downstream":
        f_at, r_at = L, -m
    elif direction == "upstream":
        f_at, r_at = -m, L
    else:
        raise ValueError(direction)
    # the sequence with m bases before it and L + m after, wrapped on a
    # circular contig and never matching (code 5) on a linear one, so the
    # base at offset d from start p is ext[m + p + d]
    if circular:
        ext = np.concatenate([codes[n - m:], codes, codes[:L + m]]) if n >= L + m else \
            np.resize(codes, n + 2 * m + L)[np.arange(-m, n + m + L) % n]
    else:
        ext = np.concatenate([np.full(m, 5, np.uint8), codes, np.full(L + m, 5, np.uint8)])
    ok_f = np.ones(n, bool)
    ok_r = np.ones(n, bool)
    for i, want in enumerate(pat):
        f = ext[m + f_at + i: m + f_at + i + n]
        r = ext[m + r_at + m - 1 - i: m + r_at + m - 1 - i + n]
        if want is None:  # any base, but not past a linear contig's ends
            ok_f &= f < 5
            ok_r &= r < 5
        else:
            ok_f &= f == want
            # reverse strand: the PAM read there is the reverse complement of
            # the forward window, so its base i sits at m - 1 - i
            ok_r &= r == COMP[want]
    if not circular:
        inside = np.arange(n) + L <= n
        ok_f &= inside
        ok_r &= inside
    return np.nonzero(ok_f)[0], np.nonzero(ok_r)[0]


def onehot(codes: np.ndarray) -> torch.Tensor:
    """(S, L) codes -> (S, 4L) float32 one-hot; code 4 is all zero."""
    S, L = codes.shape
    out = np.zeros((S, L, 4), np.float32)
    real = codes < 4
    s, l = np.nonzero(real)
    out[s, l, codes[real]] = 1.0
    return torch.from_numpy(out.reshape(S, 4 * L))


def hits(spacer_codes: np.ndarray, codes: np.ndarray, circular: bool, pam: str,
         direction: str, v: int, device: str, block: int = 8192, rows: int = 1 << 16,
         reverse: bool = True):
    """Every hit of every spacer on one contig: arrays (spacer, pos, strand,
    mismatches), strand 0 forward and 1 reverse (left out with
    ``reverse=False``: a control). Match counts are one-hot products in
    float32 with TF32 off (exact small integers), in blocks of ``rows``
    spacers by ``block`` sites."""
    S, L = spacer_codes.shape
    f, r = pam_sites(codes, circular, L, pam, direction)
    if not reverse:
        r = r[:0]
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s0 in range(0, S, rows):
            q = onehot(spacer_codes[s0:s0 + rows]).to(device)
            for strand, pos in ((0, f), (1, r)):
                for b0 in range(0, len(pos), block):
                    p = pos[b0:b0 + block]
                    w = codes[(p[:, None] + np.arange(L)) % len(codes)]
                    if strand:
                        w = revcomp_codes(w)
                    score = q @ onehot(np.ascontiguousarray(w)).to(device).T
                    s, j = torch.nonzero(score >= L - v, as_tuple=True)
                    mm = L - score[s, j].round().to(torch.int64)
                    out.append((s.cpu().numpy() + s0, p[j.cpu().numpy()],
                                np.full(len(s), strand), mm.cpu().numpy()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not out:
        return (np.zeros(0, np.int64),) * 4
    return tuple(np.concatenate(col) for col in zip(*out))


class _joinable:
    """A contig's genes by the start of their part below its length."""

    def __init__(self, genes: list, n: int):
        spans = []
        for g in genes:
            g_e = g.end + n if g.wraps else g.end
            j_s, j_e = min(max(g.start, 0), n), min(max(g_e, 0), n)
            if j_s < j_e:
                spans.append((j_s, j_e, g, g.start, g_e))
        spans.sort(key=lambda t: t[0])
        self.spans = spans
        self.starts = [t[0] for t in spans]
        self.longest = max((t[1] - t[0] for t in spans), default=0)

    def overlapping(self, a: int, b: int):
        """(gene, start, end) of every gene whose joinable part overlaps
        [a, b), in order of that part's start."""
        from bisect import bisect_left

        k = bisect_left(self.starts, b) - 1
        found = []
        while k >= 0 and self.starts[k] > a - self.longest:
            j_s, j_e, g, g_s, g_e = self.spans[k]
            if j_e > a:
                found.append((g, g_s, g_e))
            k -= 1
        return found[::-1]


def _text(codes: np.ndarray, lower: np.ndarray | None = None) -> list:
    a = LETTERS[codes].copy()
    if lower is not None:
        a[lower] += 32
    return [s.decode("ascii") for s in a.view(f"S{codes.shape[1]}").ravel()]


def table_rows(spacers: list, contigs: list, pam: str, direction: str, v: int,
               device: str = "cpu") -> tuple:
    """(columns, Counter of row tuples) of the table a ``targets`` request
    returns, for spacers of one length without repeats. ``contigs`` are the
    generator's: ``id``, ``codes``, ``circular``, ``genes``."""
    columns, rows = table(spacers, contigs, pam, direction, v, device)
    return columns, Counter(tuple(d.get(k) for k in columns) for d in rows)


def table(spacers: list, contigs: list, pam: str, direction: str, v: int,
          device: str = "cpu", reverse: bool = True) -> tuple:
    """(columns, rows as dicts) of the table: ``table_rows`` before it is
    counted."""
    if len(set(spacers)) != len(spacers):
        raise ValueError("the reference takes a library without repeated spacers")
    L, m = len(spacers[0]), len(pam)
    q = encode(spacers)
    rows = []  # (spacer, tag, gene, chr, pam, mm, target, ts, te, offset, overlap, sp, td)
    for c in contigs:
        n = len(c.codes)
        if n < L:
            continue
        s, p, strand, mm = hits(q, c.codes, c.circular, pam, direction, v, device,
                                reverse=reverse)
        if not len(s):
            continue
        w = c.codes[(p[:, None] + np.arange(L)) % n]
        rev = strand == 1
        w[rev] = revcomp_codes(w[rev])
        target = _text(w, (w != q[s]) | (w > 3) | (q[s] > 3))
        pam_at = np.where(rev, p - m, p + L) if direction == "downstream" else \
            np.where(rev, p + L, p - m)
        pw = c.codes[(pam_at[:, None] + np.arange(m)) % n]
        pw[rev] = revcomp_codes(pw[rev])
        pams = _text(pw)
        ts, te = p % n, (p + L) % n
        ts = np.where(te < ts, ts - n, ts)
        genes = _joinable(c.genes, n)
        for i in range(len(s)):
            sp = spacers[s[i]]
            a, b = int(ts[i]), int(te[i])
            base = (sp, c.id, pams[i], int(mm[i]), target[i], a, b, "R" if rev[i] else "F")
            joined = [g for g in genes.overlapping(a, b)]
            if not joined:
                rows.append(base + (None, None, None, None, None))
            for g, g_s, g_e in joined:
                off = a - g_s if g.strand == 1 else g_e - b
                rows.append(base + (g.locus_tag, g.gene or g.locus_tag, off,
                                    max(min(b, g_e) - max(a, g_s), 0),
                                    "F" if g.strand == 1 else "R"))
    sites, genes, inter = Counter(), Counter(), Counter()
    site_seen = set()
    for r in rows:
        if (r[0], r[1], r[5], r[6]) not in site_seen:
            site_seen.add((r[0], r[1], r[5], r[6]))
            sites[r[0]] += 1
        if r[8] is None:
            inter[r[0]] += 1
        else:
            genes[r[0]] += 1

    def note(sp):
        if not sites[sp]:
            return "non-targeting"
        k = sites[sp]
        parts = [f"{k} {'site' if k == 1 else 'sites'}"]
        if genes[sp]:
            parts.append(f"{genes[sp]} {'gene' if genes[sp] == 1 else 'genes'}")
        if inter[sp]:
            parts.append(f"{inter[sp]} intergenic")
        return ", ".join(parts)

    full = [dict(spacer=r[0], locus_tag=r[8], gene=r[9], chr=r[1], pam=r[2],
                 mismatches=r[3], target=r[4], tar_start=r[5], tar_end=r[6], offset=r[10],
                 overlap=r[11], sp_dir=r[7], tar_dir=r[12], note=note(r[0])) for r in rows]
    for sp in spacers:
        if not sites[sp]:
            full.append(dict(spacer=sp, note="non-targeting"))
    columns = ["spacer", "locus_tag", "gene", "chr"]
    pam_values = {d.get("pam") for d in full} - {None}
    if len(pam_values) > 1:
        columns.append("pam")
    if not all(d.get("mismatches") == 0 for d in full):
        columns.append("mismatches")
    columns += ["target", "tar_start", "tar_end", "offset", "overlap", "sp_dir", "tar_dir",
                "note"]
    return columns, full


def program_rows(table) -> tuple:
    """(columns, Counter of row tuples) of a table the program returned,
    nulls as None and whole numbers as int."""
    columns = [str(c) for c in table.columns]
    out = Counter()
    for row in table.astype(object).itertuples(index=False, name=None):
        out[tuple(_plain(x) for x in row)] += 1
    return columns, out


def _plain(x):
    if x is None:
        return None
    try:
        if x != x:  # NaN
            return None
    except TypeError:  # pandas NA
        return None
    if isinstance(x, (np.integer, int)) and not isinstance(x, bool):
        return int(x)
    if isinstance(x, (float, np.floating)) and float(x).is_integer():
        return int(x)
    return x


def rows_differing(want: tuple, got: tuple) -> int:
    """Rows in one table and not the other, counted with multiplicity; a
    table with other columns differs in every row."""
    (wc, wr), (gc, gr) = want, got
    if wc != gc:
        return sum(wr.values()) + sum(gr.values())
    return sum((wr - gr).values()) + sum((gr - wr).values())
