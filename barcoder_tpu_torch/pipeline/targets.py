"""Workload 1 — guide→genome mapping ("targets").

End-to-end equivalent of the reference's ``targets.py`` CLI: align a spacer
library against a (circular) genome at 0–v mismatches, filter by PAM,
annotate with gene features, and emit the reference's match-table schema
(frozen by Example_Libraries/CN-32-zmo.tsv's header):

    spacer locus_tag gene chr [count] [pam] [mismatches] target tar_start
    tar_end offset overlap sp_dir tar_dir note

The alignment itself runs on the device scan engine (ops/scan.py) instead of
a Bowtie subprocess (reference: targets.py:467-539); everything downstream
reproduces the reference's pandas post-processing (targets.py:542-701)
including its output quirks:

  - origin-wrapping hits report a negative tar_start (targets.py:380-384);
  - reconstructed targets lowercase mismatched bases (pysam
    ``get_reference_sequence`` semantics at targets.py:371-376);
  - rows of unannotated sites carry no ``gene`` value;
  - spacers whose every site failed PAM collapse to a single non-targeting
    row per input name (flip-to-unmapped at targets.py:350-352 +
    filter_offtargets_by_pam at targets.py:542-544).

From the scan's hits to the finished tables the row table is keyed by
integers: spacer index, contig, tar_start / tar_end, strand, locus entry.
Every sort, dedup, join and aggregate runs on them, and each string column
is built once, in the final row order, from a contiguous byte buffer or by
a gather from a small table (contig ids, locus tags, notes). The frames are
those of the pandas formulation, dtypes and index included.
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import pandas as pd
from numpy.lib.stride_tricks import sliding_window_view

from ..core.coords import fold_hit_coords_vec, get_coords, get_diff
from ..core.encode import _COMP, _LUT, COMP_ASCII, DECODE_ASCII
from ..core.genome import Contig, Genome
from ..core.pam import pam_is_trivial, pam_window_start
from ..ops import cuda_scan, scan_hits
from ..ops.prep import build_scan_array
from ..ops.scan import scan_contigs
from ..ops.types import STRAND_R, Hits
from ..seqio.library import BarcodeLibrary


@dataclass
class TargetsResult:
    table: pd.DataFrame  # final ordered/typed output table
    results: pd.DataFrame  # post-filter row table used for stats
    stats: dict


def _target_ascii(contig: Contig, hits: Hits, q_f: np.ndarray) -> np.ndarray:
    """(H, L) uint8 ASCII of the reconstructed targets: genome window in
    spacer orientation, mismatched bases lowercased (reference:
    targets.py:371-376 via pysam). R-strand windows are reverse-complemented
    as codes, so every row compares with its spacer's forward codes."""
    L = q_f.shape[1]
    scan = build_scan_array(contig, L)
    windows = np.clip(sliding_window_view(scan, L)[hits.pos], 0, 4)  # (H, L) codes
    rmask = hits.strand == STRAND_R
    if rmask.any():
        windows[rmask] = _COMP[windows[rmask]][:, ::-1]
    q = q_f[hits.spacer_idx]
    ascii_mat = DECODE_ASCII[windows]
    ascii_mat[(windows != q) | (windows == 4) | (q >= 4)] += 32  # lowercase mismatches
    return ascii_mat


def _pam_ascii(contig: Contig, hits: Hits, L: int, pam: str, direction: str) -> np.ndarray | None:
    """(H, m) uint8 ASCII of each hit's PAM window (vectorized, with
    circular wrap); None for a trivial PAM, whose column is null. Hits have
    already passed the PAM site mask, so windows are in-bounds."""
    if pam_is_trivial(pam):
        return None
    m = len(pam)
    n = contig.length
    # shared 4-way placement rule (core.pam.pam_window_start) — one source
    # of truth with extract_pam
    starts = pam_window_start(hits.pos, L, m, hits.strand == STRAND_R, direction)
    idx = starts[:, None] + np.arange(m)[None, :]
    if contig.circular:
        idx = idx % n
    codes = contig.codes[np.clip(idx, 0, n - 1)]
    ascii_mat = DECODE_ASCII[np.clip(codes, 0, 4)].copy()
    rmask = hits.strand == STRAND_R
    if rmask.any():
        ascii_mat[rmask] = COMP_ASCII[ascii_mat[rmask]][:, ::-1]
    return ascii_mat


def _intern(values: list) -> tuple[list, np.ndarray]:
    """(the distinct values other than None, in first-seen order; each
    value's index among them, -1 for None)."""
    ids: dict = {}
    codes = np.fromiter((-1 if v is None else ids.setdefault(v, len(ids)) for v in values),
                        np.int64, len(values))
    return list(ids), codes


class _Entries:
    """A locus index's entries as the rows need them, built once per index:
    ``tag`` / ``gene`` ids into ``tags`` / ``genes`` (-1 for None; the gene
    column shows the locus tag where a gene has no name), ``start``,
    ``end``, ``strand`` (0 for None), and ``sig``, the signature ids of the
    set-semantics dedup (None when no two entries share a signature)."""

    def __init__(self, entries: list):
        n = len(entries)
        self.tags, self.tag = _intern([e.locus_tag for e in entries])
        self.genes, self.gene = _intern([e.gene if e.gene else e.locus_tag for e in entries])
        self.start = np.fromiter((e.start for e in entries), np.int64, n)
        self.end = np.fromiter((e.end for e in entries), np.int64, n)
        self.strand = np.fromiter(
            (e.strand if e.strand is not None else 0 for e in entries), np.int64, n)
        # the reference's aligned_genes set (targets.py:412-416) compares
        # (locus_tag, gene, start, end, strand) by their text
        sigs: dict = {}
        sig = np.fromiter(
            (sigs.setdefault((str(e.locus_tag), str(e.gene), e.start, e.end, str(e.strand)),
                             len(sigs)) for e in entries), np.int64, n)
        self.sig = None if len(sigs) == n else sig


_ENTRIES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _entries(index) -> _Entries:
    """The entry table of a locus index, kept as long as the index lives
    (a resident genome's indexes, and so its tables, live across calls)."""
    table = _ENTRIES.get(index)
    if table is None:
        table = _ENTRIES[index] = _Entries(index.entries)
    return table


@dataclass
class RowBlock:
    """One contig's hits as rows keyed by integers (``build_rows``).

    Per hit: ``spacer`` (index into the spacer list of the call), the
    folded ``tar_start`` / ``tar_end``, ``strand``, ``mismatches``, and the
    ASCII of its ``target`` (H, L) and ``pam`` (H, m; None for a trivial
    PAM). Per row: ``hit``, ``entry`` (into ``entries``; -1 where the hit
    is in no gene), ``offset``, ``overlap``. Rows [0, n_un) are the
    unannotated hits in hit order, then one row per (hit, entry signature)
    in join order."""

    contig: Contig
    entries: _Entries
    spacer: np.ndarray
    tar_start: np.ndarray
    tar_end: np.ndarray
    strand: np.ndarray
    mismatches: np.ndarray
    target: np.ndarray
    pam: np.ndarray | None
    hit: np.ndarray
    entry: np.ndarray
    offset: np.ndarray
    overlap: np.ndarray
    n_un: int


def build_rows(
    contig: Contig,
    hits: Hits,
    q_f: np.ndarray,
    pam: str,
    pam_direction: str,
    gene_window: str = "body",
) -> RowBlock | None:
    """Expand device hits into reference-schema rows (one row per
    overlapping gene, or one with null annotation), mirroring
    parse_sam_output (targets.py:354-462), as integer columns and ASCII
    matrices: no string is made here (``postprocess`` builds the columns).
    None for no hits.

    gene_window="upstream" joins hits against promoter windows instead of
    gene bodies (targets_in_upstream.py)."""
    H = len(hits)
    if H == 0:
        return None
    L = q_f.shape[1]
    # shared fold-quirk implementation (core.coords): tar_end == 0 with a
    # negative tar_start for hits ending exactly at the origin
    tar_start, tar_end = fold_hit_coords_vec(hits.pos, L, contig.length)
    index = (
        contig.upstream_locus_index() if gene_window == "upstream" else contig.locus_index()
    )
    entries = _entries(index)
    hit_idx, entry_idx = index.join(tar_start, tar_end)
    if len(hit_idx) and entries.sig is not None:
        # set semantics per hit: drop duplicate (tag, gene, coords, strand)
        # tuples like the reference's aligned_genes set (targets.py:412-416)
        pair_key = hit_idx * (int(entries.sig.max()) + 1) + entries.sig[entry_idx]
        _, first = np.unique(pair_key, return_index=True)
        first.sort()
        hit_idx, entry_idx = hit_idx[first], entry_idx[first]
    annotated = np.zeros(H, dtype=bool)
    annotated[hit_idx] = True
    un_idx = np.flatnonzero(~annotated)

    fs, fe = entries.start[entry_idx], entries.end[entry_idx]
    fstrand = entries.strand[entry_idx]
    ts, te = tar_start[hit_idx], tar_end[hit_idx]
    offset = np.where(fstrand == 1, ts - fs, np.where(fstrand == -1, fe - te, 0)).astype(float)
    offset[fstrand == 0] = np.nan
    overlap = np.maximum(np.minimum(te, fe) - np.maximum(ts, fs), 0).astype(float)
    unset = np.full(len(un_idx), np.nan)
    return RowBlock(
        contig=contig, entries=entries, spacer=np.asarray(hits.spacer_idx, np.int64),
        tar_start=tar_start, tar_end=tar_end, strand=hits.strand,
        mismatches=hits.mismatches.astype(np.int64),
        target=_target_ascii(contig, hits, q_f),
        pam=_pam_ascii(contig, hits, L, pam, pam_direction),
        hit=np.concatenate([un_idx, hit_idx]),
        entry=np.concatenate([np.full(len(un_idx), -1, np.int64), entry_idx]),
        offset=np.concatenate([unset, offset]), overlap=np.concatenate([unset, overlap]),
        n_un=len(un_idx),
    )


def create_note(row) -> str:
    """targets.py:547-557."""
    parts = []
    if row["sites"] > 0:
        parts.append(f"{row['sites']} {'site' if row['sites'] == 1 else 'sites'}")
        if row["genes"] > 0:
            parts.append(f"{row['genes']} {'gene' if row['genes'] == 1 else 'genes'}")
        if row["intergenic"] > 0:
            parts.append(f"{row['intergenic']} intergenic")
    else:
        parts.append("non-targeting")
    return ", ".join(parts)


def _note_texts(counts: np.ndarray) -> tuple[list, np.ndarray]:
    """create_note over the rows of an (n, 3) int64 (sites, genes,
    intergenic) matrix: the distinct notes and each row's index among them.
    The count triples have tiny cardinality (~hundreds of combos at design
    scale), so each combo is formatted once — the row apply (~5.6 s/125k)
    and per-element np.char (~9 s/573k) measured far slower."""
    if len(counts) == 0:
        return [], np.zeros(0, np.int64)
    # pack the triple into one int64 when the counts fit (they always do in
    # practice; the axis=0 void-view unique measured ~1.5 s at design scale)
    b1 = int(counts[:, 1].max()).bit_length()
    b2 = int(counts[:, 2].max()).bit_length()
    if int(counts[:, 0].max()).bit_length() + b1 + b2 <= 62:
        key = (counts[:, 0] << (b1 + b2)) | (counts[:, 1] << b2) | counts[:, 2]
        uk, inv = np.unique(key, return_inverse=True)
        m2 = (np.int64(1) << b2) - 1
        m1 = (np.int64(1) << b1) - 1
        combos = np.stack([uk >> (b1 + b2), (uk >> b2) & m1, uk & m2], axis=1)
    else:  # pathological counts: fall back to the row-wise unique
        combos, inv = np.unique(counts, axis=0, return_inverse=True)
    texts = [create_note({"sites": s, "genes": g, "intergenic": i}) for s, g, i in combos]
    return texts, inv.reshape(-1)


def _lex_rank(mat: np.ndarray) -> np.ndarray:
    """Each row's place in the sorted order of the strings of a
    null-padded (n, W) uint8 ASCII matrix of distinct strings (a string
    before its extensions): the codes pd.factorize(..., sort=True) gives
    them. Bytes are renumbered over the alphabet present, so a 20-nt ACGT
    library sorts on one 64-bit key."""
    n, w = mat.shape
    present = np.zeros(256, dtype=bool)
    present[mat.reshape(-1)] = True
    code = (np.cumsum(present) - 1).clip(0).astype(np.uint64)
    bits = max(int(present.sum()) - 1, 1).bit_length()
    keys = []
    for lo in range(0, max(w, 1), 64 // bits):
        hi = min(lo + 64 // bits, w)
        key = np.zeros(n, np.uint64)
        for j in range(lo, hi):
            key |= (code << np.uint64(bits * (hi - 1 - j)))[mat[:, j]]
        keys.append(key)
    # distinct strings have distinct keys, so any sort gives one order
    order = np.lexsort(keys[::-1])
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    return rank


def _first_codes(keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Ids of int64 ``keys`` in order of first appearance (pd.factorize's
    codes, from its hash table), -1 where not ``valid``."""
    codes = np.full(len(keys), -1, np.int64)
    codes[valid] = pd.factorize(keys[valid])[0]
    return codes


_DIGITS4 = np.array([f"{i:04d}" for i in range(10_000)], "S4").view(np.uint32)


def _digits(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, 4G) uint8 ASCII digits of non-negative integers, right-aligned
    with leading zeros (4-digit groups from a table), and each one's number
    of digits."""
    top = len(str(int(v.max()))) if len(v) else 1
    groups = np.empty((len(v), -(-top // 4)), np.uint32)
    rest = v
    for k in range(groups.shape[1] - 1, -1, -1):
        rest, low = np.divmod(rest, 10_000)
        groups[:, k] = _DIGITS4[low]
    n = 1 + np.searchsorted(10 ** np.arange(1, top, dtype=np.int64), v, side="right")
    return groups.view(np.uint8).reshape(len(v), 4 * groups.shape[1]), n


def _buffer(mat: np.ndarray, lens: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A text table as one flat buffer: (bytes, offsets), row i the first
    ``lens[i]`` bytes of ``mat[i]`` (an (n, W) uint8 ASCII matrix; all W
    where lens is None)."""
    n, w = mat.shape
    if lens is None or (lens == w).all():
        return np.ascontiguousarray(mat).reshape(-1), np.arange(n + 1, dtype=np.int64) * w
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return mat[np.arange(w) < lens[:, None]], offsets


def _coords_buffer(start: np.ndarray, end: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The text table of "start..end" for non-negative starts and ends, built
    from the integers: each row's significant digits around two dots."""
    a, la = _digits(start)
    b, lb = _digits(end)
    wa = a.shape[1]
    mat = np.empty((len(start), wa + 2 + b.shape[1]), np.uint8)
    mat[:, :wa], mat[:, wa:wa + 2], mat[:, wa + 2:] = a, ord("."), b
    # which columns a row keeps depends on its two digit counts alone: one
    # pattern per pair, gathered by row
    col, wb = np.arange(mat.shape[1]), b.shape[1]
    ia, ib = np.meshgrid(np.arange(wa + 1), np.arange(wb + 1), indexing="ij")
    patterns = (((col >= wa - ia.reshape(-1, 1)) & (col < wa + 2))
                | (col >= mat.shape[1] - ib.reshape(-1, 1)))
    keep = patterns[la * (wb + 1) + lb]
    offsets = np.zeros(len(start) + 1, np.int64)
    np.cumsum(la + 2 + lb, out=offsets[1:])
    return mat[keep], offsets


def _objects(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """The strings of a flat (bytes, offsets) buffer as an object array,
    made by numpy from a null-padded matrix of the rows."""
    lens = np.diff(offsets)
    w = max(int(lens.max(initial=0)), 1)
    mat = np.zeros((len(lens), w), np.uint8)
    row = np.repeat(np.arange(len(lens)), lens)
    mat[row, np.arange(len(data)) - offsets[:-1][row]] = data
    return mat.view(f"S{w}").reshape(-1).astype(f"U{w}").astype(object)


def _text_column(table, codes: np.ndarray, dtype, nulls: tuple = (), seg=None):
    """The column whose row i is ``table[codes[i]]``, null where
    codes[i] < 0, in ``dtype``. ``table`` is a list of strings, or a flat
    (bytes, offsets) buffer, which a pyarrow string column takes whole with
    no Python string per row. In an object column a null row holds the null
    its frame of the pandas formulation leaves (``nulls[seg[i]]``: None,
    or NaN where the frame's column was a string column or absent)."""
    null = codes < 0
    if isinstance(dtype, np.dtype) and dtype.kind == "f":  # a column no frame has
        return np.full(len(codes), np.nan)
    if isinstance(dtype, pd.StringDtype) and dtype.storage == "pyarrow":
        import pyarrow as pa

        if isinstance(table, list):
            table = pa.array(table, type=pa.large_string())
        else:
            data, offsets = table
            table = pa.LargeStringArray.from_buffers(
                len(offsets) - 1, pa.py_buffer(offsets), pa.py_buffer(data))
        return pd.arrays.ArrowStringArray(table.take(pa.array(codes, mask=null)), dtype=dtype)
    table = np.array(table, dtype=object) if isinstance(table, list) else _objects(*table)
    values = np.append(table, None)[codes]
    if dtype != object:
        return pd.array(values, dtype=dtype)
    if null.any():
        values[null] = np.array(nulls, dtype=object)[seg[null]]
    return values


_KIND_SAMPLES = {"str": ["x", "x"], "mixed": ["x", None], "null": [None, None]}


@lru_cache(maxsize=256)
def _frame_dtypes(frames: tuple, columns: tuple, text_dtype) -> dict:
    """Each column's dtype in the concatenation of pandas frames whose
    columns are of the kinds given, reindexed to ``columns``, and the null
    each frame leaves in the column where it is of object dtype. ``frames``
    holds one tuple of (column, kind) pairs per frame: "str", "mixed" or
    "null" for an object array of strings, of strings and None, or of None
    alone; a numpy dtype's name otherwise. The row table's columns take
    these dtypes: those the pandas formulation (one frame per contig's
    unannotated and annotated rows, one for the spacers without a hit)
    gives them, under the pandas rules in force, which ``text_dtype`` (the
    dtype pandas gives an object array of strings) keys in the cache."""
    probes = [
        pd.DataFrame({c: np.array(_KIND_SAMPLES[k], dtype=object) if k in _KIND_SAMPLES
                      else np.ones(2, dtype=k) for c, k in frame})
        for frame in frames
    ]
    body = pd.concat(probes, ignore_index=True) if probes else pd.DataFrame(columns=columns)
    body = body.reindex(columns=list(columns))
    return {c: (body[c].dtype, tuple(body[c].to_numpy(dtype=object)[1::2])) for c in columns}


@dataclass
class _Library:
    """The call's distinct spacer sequences, in library order: ``seqs``,
    their null-padded ASCII (S, W), ``lens``, ``rank`` (place in their
    sorted order), ``n_names`` (names per sequence, duplicates included)
    and ``count`` (distinct names); both None where every sequence is its
    own one name. ``first_name``: for each (sequence, name) pair in order,
    whether the name is the sequence's first of that text (None where no
    name repeats)."""

    seqs: list
    ascii: np.ndarray
    lens: np.ndarray
    rank: np.ndarray
    n_names: np.ndarray | None = None
    count: np.ndarray | None = None
    first_name: np.ndarray | None = None


@dataclass
class _Rows:
    """The row frame of the pandas formulation, keyed by integers, in its
    order: per length group and contig, the unannotated rows, then the
    annotated ones; last the spacers without a hit (``_row_table``).

    Per row: ``sp`` (into the library), ``hit`` (-1 for a spacer without a
    hit), ``entry`` (-1 for a hit in no gene), ``offset``, ``overlap``,
    ``seg`` (its frame; ``kinds`` holds each frame's column kinds, see
    _frame_dtypes) and ``label`` (its index label: its first row in the
    frame expanded by name, of ``n_labels``). Per hit, with one more item
    at the end that the rows without a hit reach through -1: ``h_*`` (chr
    the contig id's place among the ids, n the contig's length), the
    null-padded ASCII of ``target`` and ``pam`` (None for a trivial PAM)
    and ``diff_id`` (into ``diffs``, -1 for none). Per entry, likewise:
    ``e_tag`` / ``e_gene`` (into ``tags`` / ``genes``, -1 for None) and
    ``e_strand``. ``ids``: the contigs' ids, one per ``h_contig``."""

    lib: _Library
    sp: np.ndarray
    hit: np.ndarray
    entry: np.ndarray
    offset: np.ndarray
    overlap: np.ndarray
    seg: np.ndarray
    kinds: tuple
    label: np.ndarray
    n_labels: int
    h_sp: np.ndarray
    h_contig: np.ndarray
    h_chr: np.ndarray
    h_n: np.ndarray
    h_ts: np.ndarray
    h_te: np.ndarray
    h_strand: np.ndarray
    h_mm: np.ndarray
    h_len: np.ndarray
    target: np.ndarray
    pam: np.ndarray | None
    diff_id: np.ndarray
    diffs: list
    e_tag: np.ndarray
    e_gene: np.ndarray
    e_strand: np.ndarray
    tags: list
    genes: list
    ids: list


def _merge_ids(parts: list) -> tuple[list, np.ndarray]:
    """One (values, ids) table from several (_intern's output each), equal
    values sharing an id; -1 stays -1."""
    if len(parts) == 1:
        return parts[0]
    seen: dict = {}
    out = [np.zeros(0, np.int64)]
    for values, ids in parts:
        remap = np.fromiter((seen.setdefault(v, len(seen)) for v in values), np.int64, len(values))
        out.append(np.append(remap, -1)[ids])
    return list(seen), np.concatenate(out)


def _row_table(blocks: list, unmapped: np.ndarray, lib: _Library, insert_site: bool) -> _Rows:
    """The row table of the contigs' blocks (``(RowBlock, library indices
    of its length group's spacers)``, in order) and the spacers without a
    hit."""
    contigs = list({id(b.contig): b.contig for b, _ in blocks}.values())
    tables = list({id(b.entries): b.entries for b, _ in blocks}.values())
    cpos = {id(c): i for i, c in enumerate(contigs)}
    tpos = {id(t): i for i, t in enumerate(tables)}
    ids = [c.id for c in contigs]
    chr_place = {v: i for i, v in enumerate(sorted(set(ids)))}

    tags, e_tag = _merge_ids([(t.tags, t.tag) for t in tables])
    genes, e_gene = _merge_ids([(t.genes, t.gene) for t in tables])
    e_tag, e_gene = np.append(e_tag, -1), np.append(e_gene, -1)
    e_strand = np.concatenate([t.strand for t in tables] + [np.zeros(1, np.int64)])
    e_base = np.cumsum([0] + [len(t.start) for t in tables])

    sizes = [len(b.spacer) for b, _ in blocks]
    h_base = np.cumsum([0] + sizes)

    def per_hit(parts: list, last) -> np.ndarray:
        return np.concatenate(parts + [np.array([last])])

    h_contig = per_hit([np.full(n, cpos[id(b.contig)]) for n, (b, _) in zip(sizes, blocks)],
                       len(contigs))
    h_len = per_hit([np.full(n, b.target.shape[1]) for n, (b, _) in zip(sizes, blocks)], 0)
    W = int(h_len.max())
    target = np.zeros((len(h_len), W), np.uint8)
    for (b, _), lo in zip(blocks, h_base):
        target[lo:lo + len(b.spacer), :b.target.shape[1]] = b.target
    pam = None
    if blocks and blocks[0][0].pam is not None:
        pam = np.concatenate([b.pam for b, _ in blocks] + [blocks[0][0].pam[:1] * 0])
    h_sp = per_hit([idxs[b.spacer] for b, idxs in blocks], -1)
    h_mm = per_hit([b.mismatches for b, _ in blocks], 0)

    # the mismatch descriptors: one Python string per mismatched hit
    diffs: list = []
    diff_id = np.full(len(h_len), -1, np.int64)
    for h in np.flatnonzero(h_mm > 0).tolist():
        d = get_diff(lib.seqs[h_sp[h]], target[h, :h_len[h]].tobytes().decode("ascii"))
        if d is not None:
            diff_id[h] = len(diffs)
            diffs.append(d)

    def kinds(b: RowBlock, hit: np.ndarray, entry: np.ndarray) -> tuple:
        n = len(hit)

        def kind(n_set: int) -> str:
            return "str" if n_set == n else "null" if n_set == 0 else "mixed"

        out = [("spacer", "str"), ("len", "int64"), ("target", "str"), ("mismatches", "int64"),
               ("chr", "str"), ("tar_start", b.tar_start.dtype.name),
               ("tar_end", b.tar_end.dtype.name), ("sp_dir", "str"),
               ("pam", "null" if b.pam is None else "str"), ("coords", "str"), ("type", "str"),
               ("diff", kind(np.count_nonzero(diff_id[hit] >= 0))),
               ("locus_tag", kind(np.count_nonzero(e_tag[entry] >= 0))),
               ("gene", kind(np.count_nonzero(e_gene[entry] >= 0))),
               ("offset", "float64"), ("overlap", "float64"),
               ("tar_dir", kind(np.count_nonzero(np.abs(e_strand[entry]) == 1)))]
        if insert_site:
            out += [("insSite", np.result_type(b.tar_start, b.tar_end).name),
                    ("insDirection", "str")]
        return tuple(out)

    parts, frames = [], []
    for (b, _), lo in zip(blocks, h_base):
        base = e_base[tpos[id(b.entries)]]
        for a, z, shift in ((0, b.n_un, 0), (b.n_un, len(b.hit), base)):
            if z > a:
                hit, entry = b.hit[a:z] + lo, b.entry[a:z] + shift
                frames.append(kinds(b, hit, entry))
                parts.append((h_sp[hit], hit, entry, b.offset[a:z], b.overlap[a:z]))
    if len(unmapped):
        frames.append((("spacer", "str"), ("len", "int64")))
        nan = np.full(len(unmapped), np.nan)
        none = np.full(len(unmapped), -1, np.int64)
        parts.append((unmapped, none, none, nan, nan))
    sp, hit, entry, offset, overlap = (
        np.concatenate([p[i] for p in parts]) if parts else np.zeros(0, dt)
        for i, dt in enumerate((np.int64, np.int64, np.int64, float, float)))
    seg = np.repeat(np.arange(len(parts)), [len(p[0]) for p in parts])
    if lib.n_names is None:
        label, n_labels = np.arange(len(sp)), len(sp)
    else:  # the first of each row's copies in the frame expanded by name
        per = lib.n_names[sp]
        label, n_labels = np.cumsum(per) - per, int(per.sum())

    return _Rows(
        lib=lib, sp=sp, hit=hit, entry=entry, offset=offset, overlap=overlap, seg=seg,
        kinds=tuple(frames), label=label, n_labels=n_labels,
        h_sp=h_sp, h_contig=h_contig,
        h_chr=np.array([chr_place[v] for v in ids] + [len(chr_place)], np.int64)[h_contig],
        h_n=np.array([c.length for c in contigs] + [1], np.int64)[h_contig],
        h_ts=per_hit([b.tar_start for b, _ in blocks], 0),
        h_te=per_hit([b.tar_end for b, _ in blocks], 0),
        h_strand=per_hit([b.strand for b, _ in blocks], 0),
        h_mm=h_mm, h_len=h_len, target=target, pam=pam, diff_id=diff_id, diffs=diffs,
        e_tag=e_tag, e_gene=e_gene, e_strand=e_strand, tags=tags, genes=genes, ids=ids,
    )


ROW_COLUMNS = [
    "name",
    "spacer",
    "len",
    "target",
    "mismatches",
    "chr",
    "tar_start",
    "tar_end",
    "sp_dir",
    "pam",
    "coords",
    "type",
    "diff",
    "locus_tag",
    "gene",
    "offset",
    "overlap",
    "tar_dir",
    "insSite",
    "insDirection",
]


def _cap_sites(contig_hits: list[tuple], max_sites: int) -> list[tuple]:
    """Per-spacer genome-wide site cap (the ``-k 100`` Bowtie-parity
    reporting limit, reference targets.py:502). Keeps each spacer's best
    ``max_sites`` sites ranked by (mismatches, contig order, pos, strand)
    and returns the filtered per-contig hit lists."""
    total = sum(len(h) for _, h in contig_hits)
    if total == 0:
        return contig_hits
    ci = np.concatenate(
        [np.full(len(h), i, np.int64) for i, (_, h) in enumerate(contig_hits)]
    )
    sp = np.concatenate([h.spacer_idx for _, h in contig_hits])
    pos = np.concatenate([h.pos for _, h in contig_hits])
    strand = np.concatenate([h.strand for _, h in contig_hits])
    mm = np.concatenate([h.mismatches for _, h in contig_hits])
    order = np.lexsort((strand, pos, ci, mm, sp))
    sp_sorted = sp[order]
    # rank within each spacer run of the (spacer, mm, ...) sort
    starts = np.empty(total, dtype=bool)
    starts[0] = True
    np.not_equal(sp_sorted[1:], sp_sorted[:-1], out=starts[1:])
    run_start = np.maximum.accumulate(np.where(starts, np.arange(total), 0))
    keep_sorted = (np.arange(total) - run_start) < max_sites
    keep = np.zeros(total, dtype=bool)
    keep[order[keep_sorted]] = True
    out = []
    offset = 0
    for contig, h in contig_hits:
        k = keep[offset : offset + len(h)]
        offset += len(h)
        out.append(
            (
                contig,
                Hits(h.spacer_idx[k], h.pos[k], h.strand[k], h.mismatches[k]),
            )
        )
    return out


def run_targets(
    library: BarcodeLibrary,
    genome: Genome,
    pam: str,
    mismatches: int,
    pam_direction: str = "downstream",
    backend: str = "auto",
    gene_window: str = "body",
    insert_site: bool = False,
    phases=None,
    compat_columns: bool = False,
    max_sites: int | None = None,
) -> TargetsResult:
    """gene_window: "body" (targets.py) or "upstream" promoter windows
    (targets_in_upstream.py); insert_site adds the CRISPRt insSite /
    insDirection columns (insertCharacteristics.py); compat_columns emits
    the reference insertCharacteristics camelCase header (chrom /
    CRISPRtTarget / targStart / targEnd / targDir, no sp_dir); phases:
    optional collector (utils.profiling.Phases, or any object with its
    phase / count / summary) that receives the call's stages: prepare,
    scan, annotate, assemble, postprocess, and the counters ``hits``,
    ``scan.pairs`` (the phase-1 pairs that the CUDA engine's phase 2
    re-scored; 0 on the other backends), ``scan.phase2_hits`` (the hits that
    phase 2 found there) and ``scan.phase2_relaunches`` (the phase-2
    kernel's relaunches for a full output buffer), ``rows_buffered`` and
    ``rows_per_row_strings`` (see postprocess). Each
    stage is also a span of the recorder (utils.profiling.span) under the
    call's ``targets`` span.

    max_sites: Bowtie-parity reporting cap. The reference invokes bowtie
    with ``-k 100`` (targets.py:502, BowtieRunner.py:111-125), so its
    output tables cap at 100 sites per spacer SEQUENCE on dense-hit
    libraries; this engine reports ALL hits by default (usually better —
    documented in ops/scan.py). Passing max_sites=100 reproduces the cap
    for apples-to-apples diffs against real Bowtie output. Kept sites are
    the best N by (mismatches, contig order, pos, strand) — deterministic,
    unlike Bowtie's index-order tie-breaking without --best."""
    from ..utils.profiling import Phases, span

    phases = phases if phases is not None else Phases()
    with span("targets"):
        with span("targets.prepare", phases):
            # unique sequences per length; names expand after annotation.
            # Libraries built with BarcodeLibrary.from_unique_list skip the
            # 573k-entry dict bookkeeping entirely (design workload).
            if getattr(library, "identity_unique", False):
                all_seqs = [s for _, s in library.entries]
                names_per_seq = None
                identity_names = unique_rows = True
            else:
                names_per_seq = {}
                for name, seq in library.entries:
                    names_per_seq.setdefault(seq, []).append(name)
                all_seqs = list(names_per_seq)
                identity_names = all(
                    len(v) == 1 and v[0] == k for k, v in names_per_seq.items()
                )
                # duplicate (name, seq) library entries are the one way a
                # sequence's names count differs from its distinct names
                unique_rows = identity_names or all(
                    len(v) == len(set(v)) for v in names_per_seq.values()
                )
            seq_arr = np.array(all_seqs, dtype=object)
            lens = np.fromiter(map(len, all_seqs), np.int64, len(all_seqs))
            by_len = {int(L): np.nonzero(lens == L)[0] for L in np.unique(lens)}
            # each length group's ASCII, and the library's null-padded
            # matrix, whose lexicographic rank orders the rows by spacer
            group_ascii = {
                L: np.frombuffer("".join(seq_arr[idxs].tolist()).encode("ascii"),
                                 np.uint8).reshape(len(idxs), L)
                for L, idxs in by_len.items()
            }
            seq_ascii = np.zeros((len(all_seqs), int(lens.max(initial=0))), np.uint8)
            for L, idxs in by_len.items():
                seq_ascii[idxs, :L] = group_ascii[L]
            lib = _Library(all_seqs, seq_ascii, lens, _lex_rank(seq_ascii))
            if not identity_names:
                lib.n_names = lib.count = np.fromiter(
                    map(len, names_per_seq.values()), np.int64, len(all_seqs))
            if not unique_rows:
                lib.count = np.fromiter(
                    (len(set(v)) for v in names_per_seq.values()), np.int64, len(all_seqs))
                lib.first_name = np.fromiter(
                    (v.index(name) == j for v in names_per_seq.values()
                     for j, name in enumerate(v)), bool, int(lib.n_names.sum()))

        blocks: list[tuple] = []
        # track hit spacers by global index — a string set over the row
        # frame (unique + set.update) iterated 600k arrow values per call
        seen_global = np.zeros(len(all_seqs), dtype=bool)
        for L, idxs in sorted(by_len.items()):
            with span("targets.prepare", phases):
                seqs = seq_arr[idxs].tolist()
                q_f = _LUT[group_ascii[L]]  # spacer_matrix's codes
            seen = np.zeros(len(seqs), dtype=bool)
            contig_hits: list[tuple] = []
            # contigs shorter than the spacer are ineligible for BOTH
            # topologies: linear ones cannot hold a window at all, and on a
            # circular contig with L > length the multi-wrap hits the engine
            # would find have no self-consistent folded coordinates (the
            # single-subtraction fold in build_rows yields tar_end >=
            # tar_start with wrap undetected) — the reference's bowtie path
            # reports such reads unmapped, so dropping the contig is the
            # faithful behavior
            eligible = [c for c in genome.contigs if c.length >= L]
            # one batched call per length group: multi-replicon genomes
            # share the spacer prep and pipeline per-contig device work
            # (ops.scan.scan_contigs) instead of paying each contig's round
            # trips serially
            before = (cuda_scan.pairs, cuda_scan.phase2_hit_count, scan_hits.phase2_relaunches)
            with span("targets.scan", phases):
                hits_list = (
                    scan_contigs(
                        seqs, eligible, mismatches, pam, pam_direction, backend
                    )
                    if eligible  # an empty group must not build library prep
                    else []
                )
            after = (cuda_scan.pairs, cuda_scan.phase2_hit_count, scan_hits.phase2_relaunches)
            for name, a, b in zip(("scan.pairs", "scan.phase2_hits", "scan.phase2_relaunches"),
                                  after, before):
                phases.count(name, a - b)
            for contig, hits in zip(eligible, hits_list):
                phases.count("hits", len(hits))
                contig_hits.append((contig, hits))
            if max_sites is not None:
                # the cap is per spacer across the WHOLE genome (Bowtie
                # aligns each read against the full index), so apply it
                # after all contigs of this length group have scanned
                contig_hits = _cap_sites(contig_hits, max_sites)
            for contig, hits in contig_hits:
                with span("targets.annotate", phases):
                    block = build_rows(
                        contig, hits, q_f, pam, pam_direction, gene_window=gene_window
                    )
                if block is not None:
                    seen[hits.spacer_idx] = True  # every hit emits >=1 row
                    blocks.append((block, idxs))
            seen_global[idxs[seen]] = True

        with span("targets.assemble", phases):
            # the contigs' rows, then one row per spacer with no surviving
            # hit; library-order emission
            rows = _row_table(blocks, np.flatnonzero(~seen_global), lib, insert_site)
        with span("targets.postprocess", phases):
            result = postprocess(
                rows, genome, pam, pam_direction, mismatches,
                insert_site=insert_site, compat_columns=compat_columns,
                gene_window=gene_window, phases=phases,
            )
        result.stats["profile"] = phases.summary()
    return result


def _hit_content(rows: _Rows) -> np.ndarray:
    """Ids of the hits by what their rows show: each hit its own index,
    but hits on contigs that share an id, which can show the same spacer,
    place, strand, contig length, target and PAM, one id per such content,
    from one sort over their integer columns and the byte columns of target
    and PAM."""
    n_ids = Counter(rows.ids)
    shared = np.flatnonzero(np.isin(rows.h_contig, [i for i, v in enumerate(rows.ids)
                                                    if n_ids[v] > 1]))
    keys = [k[shared] for k in (rows.h_sp, rows.h_chr, rows.h_ts, rows.h_te, rows.h_strand,
                                rows.h_mm, rows.h_n)]
    keys += [*rows.target[shared].T, *(rows.pam[shared].T if rows.pam is not None else ())]
    order = np.lexsort(keys)
    new = np.zeros(len(order), dtype=bool)
    new[:1] = True
    for k in keys:
        k = k[order]
        new[1:] |= k[1:] != k[:-1]
    key = np.arange(len(rows.h_sp))
    key[shared[order]] = len(key) + np.cumsum(new) - 1
    return key


def _repeated_rows(rows: _Rows) -> np.ndarray:
    """Rows equal in every column but the name to an earlier row: one hit
    joined to entries whose signatures differ but whose shown values agree
    (and, where contigs share an id, hits that show the same). The pandas
    formulation drops them when it drops the name column (targets.py:636)."""
    dup = np.zeros(len(rows.sp), dtype=bool)
    has = rows.hit >= 0
    key = _hit_content(rows)[rows.hit]
    many = np.bincount(key[has])[key[has]] > 1
    cand = np.flatnonzero(has)[many]
    if len(cand) < 2:
        return dup
    e = rows.entry[cand]
    strand = rows.e_strand[e]
    keys = [np.nan_to_num(rows.overlap[cand], nan=np.inf),
            np.nan_to_num(rows.offset[cand], nan=np.inf),
            np.where(np.abs(strand) == 1, strand, 0), rows.e_gene[e], rows.e_tag[e], key[cand]]
    order = np.lexsort(keys)
    same = np.ones(len(cand) - 1, dtype=bool)
    for k in keys:
        k = k[order]
        same &= k[1:] == k[:-1]
    dup[cand[order[1:][same]]] = True
    return dup


def _index(rows: _Rows, repeated: np.ndarray, sorted_rows: np.ndarray) -> pd.Index:
    """The index the pandas formulation leaves: each kept row's label, in a
    RangeIndex where its takes keep one (a mask that drops nothing takes
    nothing). ``sorted_rows``: every row in the sorted order. Where names
    are not the sequences it replays the formulation's takes on the frame
    expanded by name: where a sequence repeats a name, drop the repeated
    (name, row) pairs; sort; drop the rows that differ by name alone."""
    lib = rows.lib
    if lib.n_names is None:
        return pd.RangeIndex(rows.n_labels).take(sorted_rows)
    per = lib.n_names[rows.sp]
    body = np.repeat(np.arange(len(per)), per)
    index = pd.RangeIndex(len(body))
    if lib.first_name is not None:
        start = np.cumsum(lib.n_names) - lib.n_names
        kept = ~repeated[body] & lib.first_name[
            start[rows.sp[body]] + np.arange(len(body)) - rows.label[body]]
        if not kept.all():
            index, body = index.take(np.flatnonzero(kept)), body[kept]
    place = np.empty(len(per), np.int64)
    place[sorted_rows] = np.arange(len(sorted_rows))
    step = np.argsort(place[body], kind="stable")
    index, body = index.take(step), body[step]
    kept = np.r_[True, body[1:] != body[:-1]][:len(body)] & ~repeated[body]
    return index if kept.all() else index.take(np.flatnonzero(kept))


def _num(values: np.ndarray, null: np.ndarray, dtype) -> np.ndarray:
    """A numeric column in its frame dtype: NaN on the null rows where that
    is a float."""
    if isinstance(dtype, np.dtype) and dtype.kind == "f":
        values = values.astype(dtype)
        values[null] = np.nan
        return values
    return values.astype(dtype)


def postprocess(
    rows: _Rows,
    genome: Genome,
    pam: str,
    pam_direction: str,
    mismatches: int,
    insert_site: bool = False,
    compat_columns: bool = False,
    gene_window: str = "body",
    phases=None,
) -> TargetsResult:
    """The reference's main() dataframe stage (targets.py:605-701) plus the
    summary-statistics inputs for its rich table (targets.py:716-861), on
    the integer row table; each string column is made once, in the final
    row order.

    The SAM-stream dedup (targets.py:607) and filter_offtargets_by_pam
    (targets.py:542-544) drop nothing from this table: hits are unique on
    (spacer, pos, strand), a hit's entries on their signature, and a
    spacer gets its unmapped row only when it has no hit. Where names are
    not the sequences, rows that differ in the name alone are one row.

    phases counts ``rows_buffered`` (rows whose strings all came from a
    buffer or a table) and ``rows_per_row_strings``: rows of a hit across
    the origin, whose coords ``get_coords`` writes once per row, or of a
    mismatched hit, whose diff ``get_diff`` writes once per hit (in
    _row_table, whatever it returns) for all the hit's rows. Rows, not
    calls: the two counters add up to the table's rows."""
    lib = rows.lib
    # the ["chr", "min_tar", "spacer"] order: min_tar == tar_start, since
    # build_rows folds origin-wrapping hits to a NEGATIVE tar_start (rows
    # without a hit sort last, then by spacer)
    sorted_rows = np.lexsort((lib.rank[rows.sp], rows.h_ts[rows.hit], rows.h_chr[rows.hit]))
    repeated = (_repeated_rows(rows) if lib.n_names is not None
                else np.zeros(len(rows.sp), dtype=bool))
    order = sorted_rows[~repeated[sorted_rows]]
    sp, hit, entry, seg = rows.sp[order], rows.hit[order], rows.entry[order], rows.seg[order]
    R = len(order)
    has_t = hit >= 0
    ts, te, mm = rows.h_ts[hit], rows.h_te[hit], rows.h_mm[hit]
    wrap = ts < 0

    # the helper codes, null → -1: spacer and chr by their strings' order,
    # coords and locus_tag in order of first appearance; a site is (chr,
    # coords) (targets.py:640-667)
    code_sp = lib.rank[sp]
    present = np.zeros(len(set(rows.ids)) + 1, dtype=bool)
    present[rows.h_chr[hit[has_t]]] = True
    code_chr = np.where(has_t, np.cumsum(present)[rows.h_chr[hit]] - 1, -1)
    coo_key = ts * (int(rows.h_n.max()) + 1) + te
    wrapped = np.flatnonzero(wrap)
    wrapped_text = [get_coords(int(a), int(b), int(n)) for a, b, n in
                    zip(ts[wrapped], te[wrapped], rows.h_n[hit[wrapped]])]
    texts_seen: dict = {}
    coo_key[wrapped] = [-2 - texts_seen.setdefault(s, len(texts_seen)) for s in wrapped_text]
    code_coo = _first_codes(coo_key, has_t)
    tag = rows.e_tag[entry]
    code_lt = _first_codes(tag, tag >= 0)

    # per spacer (by code): names, distinct sites, gene rows, intergenic rows
    S = len(lib.rank)
    count = np.ones(S, np.int64)
    if lib.count is not None:
        count[lib.rank] = lib.count
    genes = np.bincount(code_sp[tag >= 0], minlength=S)
    intergenic = np.bincount(code_sp[(tag < 0) & has_t], minlength=S)
    site = code_chr * (int(code_coo.max(initial=-1)) + 2) + code_coo
    sites = _distinct_per(code_sp[has_t], site[has_t], S)
    notes, note_of = _note_texts(np.stack([sites, genes, intergenic], axis=1))

    columns = [c for c in (ROW_COLUMNS if insert_site else ROW_COLUMNS[:-2]) if c != "name"]
    text_dtype = pd.Series(np.array(["x"], dtype=object)).dtype
    dtypes = dict(_frame_dtypes(rows.kinds, tuple(columns), text_dtype))
    dtypes["note"] = (text_dtype, ())  # the notes are assigned as an object array

    def text(col: str, table, codes: np.ndarray):
        dtype, nulls = dtypes[col]
        return _text_column(table, codes, dtype, nulls, seg)

    def num(col: str, values: np.ndarray):
        return _num(values, ~has_t, dtypes[col][0])

    strand_r = np.where(has_t, rows.h_strand[hit] == STRAND_R, -1)
    e_strand = rows.e_strand[entry]
    # coords: the plain rows' text from their integers, then the rows
    # across the origin, whose get_coords text follows them in the table
    plain = np.flatnonzero(has_t & ~wrap)
    data, offsets = _coords_buffer(ts[plain], te[plain])
    if len(wrapped):
        raw = "".join(wrapped_text).encode("ascii")
        data = np.concatenate([data, np.frombuffer(raw, np.uint8)])
        offsets = np.concatenate(
            [offsets, offsets[-1] + np.cumsum([len(t) for t in wrapped_text])])
    coords_of = np.full(R, -1, np.int64)
    coords_of[plain] = np.arange(len(plain))
    coords_of[wrapped] = len(plain) + np.arange(len(wrapped))
    cols = {
        "spacer": text("spacer", _buffer(lib.ascii, lib.lens), sp),
        "len": lib.lens[sp].astype(dtypes["len"][0]),
        "target": text("target", _buffer(rows.target[:-1], rows.h_len[:-1]), hit),
        "mismatches": num("mismatches", mm),
        "chr": text("chr", rows.ids, np.where(has_t, rows.h_contig[hit], -1)),
        "tar_start": num("tar_start", ts),
        "tar_end": num("tar_end", te),
        "sp_dir": text("sp_dir", ["F", "R"], strand_r),
        "pam": text("pam", [], np.full(R, -1)) if rows.pam is None else
        text("pam", _buffer(rows.pam[:-1]), hit),
        "coords": text("coords", (data, offsets), coords_of),
        "type": text("type", ["perfect", "mismatch"], np.where(has_t, mm > 0, -1)),
        "diff": text("diff", rows.diffs, rows.diff_id[hit]),
        "locus_tag": text("locus_tag", rows.tags, tag),
        "gene": text("gene", rows.genes, rows.e_gene[entry]),
        "offset": rows.offset[order].astype(dtypes["offset"][0]),
        "overlap": rows.overlap[order].astype(dtypes["overlap"][0]),
        "tar_dir": text("tar_dir", ["F", "R"], np.where(e_strand == 1, 0,
                                                        np.where(e_strand == -1, 1, -1))),
    }
    if insert_site:
        # insertion 49 bp downstream of the target end (F) / upstream of
        # the start (R), mod chromosome length (insertCharacteristics.py:482-486)
        n = rows.h_n[hit]
        cols["insSite"] = num("insSite", np.where(strand_r == 1, (ts - 49) % n, (te + 49) % n))
        cols["insDirection"] = text("insDirection", ["F", "R"], strand_r)
    if R:
        cols["min_tar"] = np.where(has_t, ts, np.nan)
    cols.update({
        "_sp": code_sp, "_chr": code_chr, "_coo": code_coo, "_lt": code_lt,
        "count": count[code_sp], "sites": sites[code_sp], "genes": genes[code_sp],
        "intergenic": intergenic[code_sp],
        "note": text("note", notes, note_of[code_sp]) if R else
        np.zeros(0, dtype=object),
    })
    index = _index(rows, repeated, sorted_rows)
    results = pd.DataFrame(
        {c: pd.Series(v, index=index, copy=False,
                      dtype=object if isinstance(v, np.ndarray) and v.dtype == object else None)
         for c, v in cols.items()},
        copy=False,
    )
    if phases is not None:
        per_row = int(np.count_nonzero(has_t & (wrap | (mm > 0))))
        phases.count("rows_buffered", R - per_row)
        phases.count("rows_per_row_strings", per_row)

    spacer_lengths = np.flatnonzero(np.bincount(lib.lens[sp])).tolist()
    spacer_len_range = ",".join(str(x) for x in spacer_lengths)

    pam_rows = rows.pam[hit[has_t]] if rows.pam is not None else np.zeros((0, 0))
    column_order = ["spacer", "locus_tag", "gene", "chr"]
    if not (results["count"] == 1).all():
        column_order.append("count")
    if len(pam_rows) and not (pam_rows == pam_rows[0]).all():
        column_order.append("pam")
    if not (results["mismatches"] == 0).all():
        column_order.append("mismatches")
    if insert_site:
        # insertCharacteristics.py:811-823 places the insertion columns
        # between overlap and the target direction
        column_order.extend(
            ["target", "tar_start", "tar_end", "offset", "overlap",
             "insDirection", "insSite", "sp_dir", "tar_dir", "note"]
        )
    else:
        column_order.extend(
            ["target", "tar_start", "tar_end", "offset", "overlap", "sp_dir", "tar_dir", "note"]
        )

    final_results = results.reindex(columns=column_order)
    for col in ["count", "mismatches", "offset", "overlap", "tar_start", "tar_end"]:
        if col in final_results.columns:
            final_results[col] = final_results[col].astype("Int64")
    if insert_site and compat_columns:
        # byte-level insertCharacteristics.py header compatibility
        # (insertCharacteristics.py:800-823): the reference's CRISPRt table
        # has no sp_dir column (insDirection carries the read direction) and
        # uses camelCase names; dropping sp_dir leaves exactly its order
        # [..., overlap, insDirection, insSite, targDir, note]. insSite is
        # deliberately absent from its Int64 list (:828-833) — kept float.
        final_results = final_results.drop(columns=["sp_dir"]).rename(
            columns={"chr": "chrom", "target": "CRISPRtTarget",
                     "tar_start": "targStart", "tar_end": "targEnd",
                     "tar_dir": "targDir"}
        )

    stats = _summary_stats(results, final_results, genome, spacer_len_range,
                           pam, pam_direction, mismatches,
                           gene_window=gene_window)
    return TargetsResult(table=final_results, results=results, stats=stats)


def _n_distinct(codes: np.ndarray) -> int:
    """Distinct non-negative codes (≡ .nunique() on the column the codes
    were factorized from, which excludes nulls)."""
    codes = codes[codes >= 0]
    return int(np.count_nonzero(np.bincount(codes))) if len(codes) else 0


def _distinct_per(group: np.ndarray, value: np.ndarray, minlength: int = 0) -> np.ndarray:
    """Distinct non-negative ``value``s per non-negative ``group`` code,
    indexed by the code."""
    span = int(value.max(initial=0)) + 1
    key = np.sort(group * span + value)
    distinct = key[np.r_[True, key[1:] != key[:-1]]] if len(key) else key
    return np.bincount(distinct // span, minlength=minlength)


def _summary_stats(
    results: pd.DataFrame,
    final_results: pd.DataFrame,
    genome: Genome,
    spacer_len_range: str,
    pam: str,
    pam_direction: str,
    mismatches: int,
    gene_window: str = "body",
) -> dict:
    # the upstream tool reports PROMOTER-WINDOW ambiguity, not gene-body
    # ambiguity (targets_in_upstream.py:786-807) — the two maps overlap
    # independently
    ambiguous_coordinates, ambiguous_locus_tags = genome.ambiguity_stats(
        gene_window
    )
    # every aggregate below runs on postprocess's codes ("_sp"/"_chr"/
    # "_coo"/"_lt", null → -1) with bincount / unique
    sp, chr_, coo, lt = (results[c].to_numpy(np.int64) for c in ("_sp", "_chr", "_coo", "_lt"))
    has_t = results["target"].notna().to_numpy()
    stats = {
        "pam": pam,
        "pam_direction": pam_direction,
        "mismatches": mismatches,
        "spacer_len_range": spacer_len_range,
        "systematic_name": (
            f"{spacer_len_range}-{pam}" if pam_direction == "downstream" else f"{pam}-{spacer_len_range}"
        ),
        "organisms": sorted({v for v in genome.organisms.values() if v}),
        "topologies": sorted({str(v) for v in genome.topologies.values()}),
        "seq_lens": sorted(set(genome.seq_lens.values())),
        "chromosomes": len(genome.seq_lens),
        "total_genes": sum(genome.all_genes.values()),
        "overlapping_genes": ambiguous_locus_tags,
        "ambiguous_coordinates": ambiguous_coordinates,
        "chromosomes_targeted": _n_distinct(chr_),
        "genes_targeted": _n_distinct(lt),
        "overlapping_genes_targeted": _n_distinct(lt[results["genes"].to_numpy() > 1]),
        "unique_barcodes": _n_distinct(sp),
        "intergenic_barcodes": _n_distinct(sp[(lt < 0) & (chr_ >= 0)]),
        # ≡ apply(set).apply(len) > 1 over the targeted rows' coords
        "off_target_barcodes": int(np.count_nonzero(_distinct_per(sp[has_t], coo[has_t]) > 1)),
        "non_targeting_barcodes": _n_distinct(sp[~has_t]),
    }
    if "mismatches" in final_results.columns:
        # same rows as final_results, distinct spacers per mismatch count
        mm = results["mismatches"].to_numpy(np.float64)
        ok = ~np.isnan(mm)
        per_mm = _distinct_per(mm[ok].astype(np.int64), sp[ok])
        stats["spacers_per_mismatch"] = {int(k): int(v) for k, v in enumerate(per_mm) if v}
    return stats


def write_output(result: TargetsResult, stream, as_json: bool = False) -> None:
    """TSV (default) or JSON records, reproducing targets.py:696-701."""
    if as_json:
        stream.write(result.table.to_json(orient="records", indent=4))
        stream.write("\n")
    else:
        result.table.to_csv(stream, sep="\t", index=False, na_rep="None")
