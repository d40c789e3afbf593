"""Plain reference of a ``design`` request with ``omit_offtargets`` and
otherwise the default options (v = 1, forward orientation, intergenic
guides left out, tiles of the spacer's length, the 10 first guides of each
gene): the selected rows, and how many spacers the off-target step removed.

It is ``design_ref.design_rows`` with one step added after the orientation
filter:

- candidates: every distinct spacer-length window at a PAM site, on either
  strand (``design_ref.candidates``);
- the candidates are mapped back as a ``targets`` request at v
  (``targets_ref.table``), notes included;
- rows survive where the spacer's direction is the gene's;
- off-targets: rows survive whose spacer has exactly one site at <= v
  mismatches over every contig and both strands, a site being a distinct
  (contig, start, end) among the spacer's hits as this reference found
  them (the count its own note leads with); each row gains the column
  ``sites``, that count;
- then as ``design_ref``: no mismatch, no intergenic site in the note, the
  per-gene tiling, the first ``keep_top`` spacers of each gene; numbers
  whole (a missing one reads 0).

Departures from ``design_guides.py:111-310``, as ``design_ref`` makes them:
the candidates are mapped by this reference's exhaustive one-hot scan, not
by Bowtie (no cap of 100 sites a spacer), so the note the site count is
read from is this reference's, never the program's; and the rows are
compared as a multiset, so the final sort is not reproduced.

The mapping is ``targets_ref.table`` with its scan, ``targets_ref.hits``,
swapped for ``hits`` below for the call: the same hits, found with each
strand's site one-hots built once a contig on the device and multiplied in
larger blocks, in float16 on a CUDA card. The products count matching
positions, whole numbers of at most the spacer's length, which float16
holds exactly."""

from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np
import torch

from . import design_ref, targets_ref


def _onehot(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(S, L) codes -> (S, 4L) one-hot in ``targets_ref.onehot``'s layout;
    a code above 3 is all zero."""
    bases = torch.arange(4, dtype=w.dtype, device=w.device)
    return (w[..., None] == bases).to(dtype).reshape(len(w), -1)


def hits(spacer_codes: np.ndarray, codes: np.ndarray, circular: bool, pam: str,
         direction: str, v: int, device: str, rows: int = 1 << 15, block: int = 1 << 16,
         reverse: bool = True):
    """``targets_ref.hits``' arrays (spacer, pos, strand, mismatches), in
    another order: one strand's site windows one-hot encoded once, and
    products of ``rows`` spacers by ``block`` sites."""
    S, L = spacer_codes.shape
    n = len(codes)
    f, r = targets_ref.pam_sites(codes, circular, L, pam, direction)
    if not reverse:
        r = r[:0]
    dtype = torch.float16 if str(device).startswith("cuda") else torch.float32
    q = _onehot(torch.from_numpy(spacer_codes).to(device), dtype)
    out = []
    for strand, pos in ((0, f), (1, r)):
        if not len(pos):
            continue
        w = codes[(pos[:, None] + np.arange(L)) % n]
        if strand:
            w = targets_ref.revcomp_codes(w)
        g = _onehot(torch.from_numpy(np.ascontiguousarray(w)).to(device), dtype)
        for s0 in range(0, S, rows):
            for b0 in range(0, len(pos), block):
                score = q[s0:s0 + rows] @ g[b0:b0 + block].T
                s, j = torch.nonzero(score >= L - v, as_tuple=True)
                mm = L - score[s, j].to(torch.int64)
                out.append((s.cpu().numpy() + s0, pos[j.cpu().numpy() + b0],
                            np.full(len(s), strand), mm.cpu().numpy()))
        del g
    if not out:
        return (np.zeros(0, np.int64),) * 4
    return tuple(np.concatenate(col) for col in zip(*out))


@contextlib.contextmanager
def _scan_by_blocks():
    """``targets_ref.table`` scanning with ``hits`` for the call."""
    scan = targets_ref.hits
    targets_ref.hits = hits
    try:
        yield
    finally:
        targets_ref.hits = scan


def mapped(contigs: list, L: int, pam: str, direction: str, v: int = 1,
           device: str = "cpu") -> tuple:
    """(columns, rows as dicts) of the candidates mapped back at ``v``,
    with a ``mismatches`` column whether or not any hit has one."""
    spacers = design_ref.candidates(contigs, L, pam, direction)
    with _scan_by_blocks():
        columns, rows = targets_ref.table(spacers, contigs, pam, direction, v, device)
    if "mismatches" not in columns:
        columns = columns + ["mismatches"]
        for d in rows:
            d["mismatches"] = 0
    return columns, rows


def design_rows(table: tuple, L: int, keep_top: int = 10, tile: int | None = None,
                offtargets: bool = True) -> tuple:
    """(columns, Counter of row tuples, spacers the off-target step removed)
    of the table ``run_design`` selects from ``table`` (``mapped``'s);
    ``offtargets=False`` leaves the off-target step out but still writes
    ``sites`` (a control)."""
    tile = tile or L
    columns, rows = table
    rows = [d for d in rows if d.get("locus_tag") is not None and d["sp_dir"] == d["tar_dir"]]
    sites = {d["spacer"]: int(d["note"].split(" ", 1)[0]) for d in rows}
    removed = 0
    if offtargets:
        removed = sum(k != 1 for k in sites.values())
        rows = [d for d in rows if sites[d["spacer"]] == 1]
    rows = [d for d in rows if d.get("mismatches") == 0 and "intergenic" not in d["note"]]
    chosen = set()
    for gene_rows in design_ref._by_gene(rows).values():
        last = gene_rows[0]["offset"]
        chosen.add(gene_rows[0]["spacer"])
        for d in gene_rows:
            if d["offset"] >= last + tile:
                chosen.add(d["spacer"])
                last = d["offset"]
    rows = [d for d in rows if d["spacer"] in chosen]
    kept = {d["spacer"] for gene_rows in design_ref._by_gene(rows).values()
            for d in gene_rows[:keep_top]}
    rows = [d for d in rows if d["spacer"] in kept]
    numbers = design_ref._NUMBERS
    return columns + ["sites"], Counter(
        tuple(0 if d.get(k) is None and k in numbers else d.get(k) for k in columns)
        + (sites[d["spacer"]],) for d in rows), removed
