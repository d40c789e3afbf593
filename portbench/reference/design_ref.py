"""Plain reference of a ``design`` request with the default options
(v = 1, forward orientation, intergenic guides left out, tiles of the
spacer's length, the 10 first guides of each gene): the selected rows.

- candidates: every distinct spacer-length window at a PAM site, on either
  strand (the reverse one read as its reverse complement);
- the candidates are mapped back as a ``targets`` request at v
  (``targets_ref.table``), notes included;
- rows survive where the spacer's direction is the gene's, with no
  mismatch, and whose note names no intergenic site;
- per gene, rows in order of offset: the first one's spacer is selected,
  then each spacer at least a tile past the last selected; rows of selected
  spacers survive;
- per gene, rows in order of offset: the spacers of the first ``keep_top``
  are kept; rows of kept spacers survive;
- numbers are whole (a missing one reads 0)."""

from __future__ import annotations

from collections import Counter

import numpy as np

from . import targets_ref


def candidates(contigs: list, L: int, pam: str, direction: str) -> list:
    seen = set()
    for c in contigs:
        f, r = targets_ref.pam_sites(c.codes, c.circular, L, pam, direction)
        for pos, rev in ((f, False), (r, True)):
            w = c.codes[(pos[:, None] + np.arange(L)) % len(c.codes)]
            if rev:
                w = targets_ref.revcomp_codes(w)
            w = np.ascontiguousarray(w)
            seen.update(targets_ref.LETTERS[w[(w < 4).all(axis=1)]].view(f"S{L}").ravel())
    return sorted(s.decode("ascii") for s in seen)


def _by_gene(rows: list) -> dict:
    """Rows of each gene, in order of offset (then position and spacer)."""
    genes = {}
    for d in sorted(rows, key=lambda d: (d["offset"], d["chr"], d["tar_start"], d["spacer"])):
        genes.setdefault(d["locus_tag"], []).append(d)
    return genes


def design_rows(contigs: list, L: int, pam: str, direction: str, v: int = 1,
                keep_top: int = 10, tile: int | None = None, device: str = "cpu",
                reverse: bool = True) -> tuple:
    """(columns, Counter of row tuples) of the table ``run_design`` selects;
    ``reverse=False`` leaves the reverse strand's hits out (a control)."""
    tile = tile or L
    spacers = candidates(contigs, L, pam, direction)
    columns, rows = targets_ref.table(spacers, contigs, pam, direction, v, device, reverse)
    if "mismatches" not in columns:
        columns = columns + ["mismatches"]
        for d in rows:
            d["mismatches"] = 0
    rows = [d for d in rows if d.get("locus_tag") is not None
            and d["sp_dir"] == d["tar_dir"] and d.get("mismatches") == 0
            and "intergenic" not in d["note"]]
    chosen = set()
    for gene_rows in _by_gene(rows).values():
        last = gene_rows[0]["offset"]
        chosen.add(gene_rows[0]["spacer"])
        for d in gene_rows:
            if d["offset"] >= last + tile:
                chosen.add(d["spacer"])
                last = d["offset"]
    rows = [d for d in rows if d["spacer"] in chosen]
    kept = {d["spacer"] for gene_rows in _by_gene(rows).values() for d in gene_rows[:keep_top]}
    rows = [d for d in rows if d["spacer"] in kept]
    return columns, Counter(tuple(0 if d.get(k) is None and k in _NUMBERS else d.get(k)
                                  for k in columns) for d in rows)


_NUMBERS = {"mismatches", "tar_start", "tar_end", "offset", "overlap"}
