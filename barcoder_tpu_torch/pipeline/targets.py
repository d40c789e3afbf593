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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd
from numpy.lib.stride_tricks import sliding_window_view

from ..core.coords import fold_hit_coords_vec, get_coords, get_diff
from ..core.encode import COMP_ASCII, DECODE_ASCII
from ..core.genome import Contig, Genome
from ..core.pam import pam_is_trivial, pam_window_start
from ..ops.prep import build_scan_array, revcomp_matrix, spacer_matrix
from ..ops.scan import scan_contigs
from ..ops.types import STRAND_R, Hits
from ..seqio.library import BarcodeLibrary


@dataclass
class TargetsResult:
    table: pd.DataFrame  # final ordered/typed output table
    results: pd.DataFrame  # post-filter row table used for stats
    stats: dict


def _decode_rows(mat_ascii: np.ndarray) -> list[str]:
    """(H, L) uint8 ascii → list of strings."""
    if mat_ascii.size == 0:
        return []
    H, L = mat_ascii.shape
    flat = np.ascontiguousarray(mat_ascii).view(f"S{L}").ravel()
    return [b.decode("ascii") for b in flat]


def _target_strings(
    contig: Contig, hits: Hits, q_f: np.ndarray, q_r: np.ndarray
) -> list[str]:
    """Reconstructed target sequences: genome window in spacer orientation,
    mismatched bases lowercased (reference: targets.py:371-376 via pysam)."""
    L = q_f.shape[1]
    scan = build_scan_array(contig, L)
    windows = sliding_window_view(scan, L)[hits.pos]  # (H, L) codes
    q = np.where(hits.strand[:, None] == STRAND_R, q_r[hits.spacer_idx], q_f[hits.spacer_idx])
    match = (windows == q) & (windows < 4) & (q < 4)
    ascii_mat = DECODE_ASCII[np.clip(windows, 0, 4)].copy()
    ascii_mat[~match] += 32  # lowercase mismatches
    # R-strand rows: reverse complement preserving case
    rmask = hits.strand == STRAND_R
    if rmask.any():
        rc = COMP_ASCII[ascii_mat[rmask]][:, ::-1]
        ascii_mat[rmask] = rc
    return _decode_rows(ascii_mat)


def _pam_strings(contig: Contig, hits: Hits, L: int, pam: str, direction: str) -> list:
    """Extracted PAM windows per hit (vectorized, with circular wrap). Hits
    have already passed the PAM site mask, so windows are in-bounds."""
    if pam_is_trivial(pam):
        return [None] * len(hits)
    m = len(pam)
    n = contig.length
    # shared 4-way placement rule (core.pam.pam_window_start) — one source
    # of truth with extract_pam
    starts = pam_window_start(hits.pos, L, m, hits.strand == STRAND_R,
                              direction)
    idx = starts[:, None] + np.arange(m)[None, :]
    if contig.circular:
        idx = idx % n
    codes = contig.codes[np.clip(idx, 0, n - 1)]
    ascii_mat = DECODE_ASCII[np.clip(codes, 0, 4)].copy()
    rmask = hits.strand == STRAND_R
    if rmask.any():
        ascii_mat[rmask] = COMP_ASCII[ascii_mat[rmask]][:, ::-1]
    return _decode_rows(ascii_mat)


def build_rows(
    contig: Contig,
    hits: Hits,
    seqs: list[str],
    q_f: np.ndarray,
    q_r: np.ndarray,
    pam: str,
    pam_direction: str,
    gene_window: str = "body",
    insert_site: bool = False,
) -> pd.DataFrame:
    """Expand device hits into a reference-schema row frame (one row per
    overlapping gene, or one with null annotation), mirroring
    parse_sam_output (targets.py:354-462) — fully vectorized so the design
    workload's ~10^6 hit rows assemble in numpy, not a Python loop.

    gene_window="upstream" joins hits against promoter windows instead of
    gene bodies (targets_in_upstream.py); insert_site=True adds the CRISPRt
    transposon insertion-site columns — insertion 49 bp downstream of the
    target end (F) / upstream of the start (R), mod chromosome length
    (insertCharacteristics.py:482-486)."""
    H = len(hits)
    if H == 0:
        return pd.DataFrame()
    L = q_f.shape[1]
    n = contig.length
    # shared fold-quirk implementation (core.coords): tar_end == 0 with a
    # negative tar_start for hits ending exactly at the origin
    tar_start, tar_end = fold_hit_coords_vec(hits.pos, L, n)
    wrap = tar_start < 0

    targets = np.array(_target_strings(contig, hits, q_f, q_r), dtype=object)
    pams = np.array(_pam_strings(contig, hits, L, pam, pam_direction), dtype=object)
    sp_dirs = np.where(hits.strand == STRAND_R, "R", "F")
    seq_arr = np.array(seqs, dtype=object)
    spacers = seq_arr[hits.spacer_idx]
    mm = hits.mismatches.astype(np.int64)

    coords = np.empty(H, dtype=object)
    plain = ~wrap
    ts_p = tar_start[plain]
    te_p = tar_end[plain]
    coords[plain] = [f"{a}..{b}" for a, b in zip(ts_p.tolist(), te_p.tolist())]
    if wrap.any():
        coords[wrap] = [
            get_coords(int(a), int(b), n)
            for a, b in zip(tar_start[wrap], tar_end[wrap])
        ]

    diffs = np.full(H, None, dtype=object)
    mm_rows = np.nonzero(mm > 0)[0]
    for i in mm_rows.tolist():
        diffs[i] = get_diff(spacers[i], targets[i])

    index = (
        contig.upstream_locus_index() if gene_window == "upstream" else contig.locus_index()
    )
    hit_idx, entry_idx = index.join(tar_start, tar_end)
    # set semantics per hit: drop duplicate (tag, gene, coords, strand)
    # tuples like the reference's aligned_genes set (targets.py:412-416)
    if len(hit_idx):
        # signature ids over the (small) entry table, then one int64 unique
        # over the pairs — the object-string pair_key unique measured ~2 s
        # at design scale (600k pairs)
        sig_keys = np.array(
            [
                "\x00".join(
                    map(str, (e.locus_tag, e.gene, e.start, e.end, e.strand))
                )
                for e in index.entries  # the list entry_idx indexes
            ],
            dtype=object,
        )
        _, sig_ids = np.unique(sig_keys, return_inverse=True)
        n_sigs = int(sig_ids.max()) + 1 if len(sig_ids) else 1
        pair_key = hit_idx.astype(np.int64) * n_sigs + sig_ids[entry_idx]
        _, uniq = np.unique(pair_key, return_index=True)
        uniq.sort()
        hit_idx, entry_idx = hit_idx[uniq], entry_idx[uniq]

    base_cols = {
        "spacer": spacers,
        "len": np.full(H, L, dtype=np.int64),
        "target": targets,
        "mismatches": mm,
        "chr": np.full(H, contig.id, dtype=object),
        "tar_start": tar_start,
        "tar_end": tar_end,
        "sp_dir": sp_dirs.astype(object),
        "pam": pams,
        "coords": coords,
        "type": np.where(mm > 0, "mismatch", "perfect").astype(object),
        "diff": diffs,
    }
    if insert_site:
        base_cols["insSite"] = np.where(
            hits.strand == STRAND_R, (tar_start - 49) % n, (tar_end + 49) % n
        )
        base_cols["insDirection"] = sp_dirs.astype(object)

    entries = index.entries  # same list entry_idx was built over
    annotated_mask = np.zeros(H, dtype=bool)
    annotated_mask[hit_idx] = True
    un_idx = np.nonzero(~annotated_mask)[0]

    frames = []
    if len(un_idx):
        d = {k: v[un_idx] for k, v in base_cols.items()}
        d["locus_tag"] = np.full(len(un_idx), None, dtype=object)
        d["gene"] = np.full(len(un_idx), None, dtype=object)
        d["offset"] = np.full(len(un_idx), np.nan)
        d["overlap"] = np.full(len(un_idx), np.nan)
        d["tar_dir"] = np.full(len(un_idx), None, dtype=object)
        frames.append(pd.DataFrame(d))
    if len(hit_idx):
        e_tag = np.array([e.locus_tag for e in entries], dtype=object)
        e_gene = np.array(
            [e.gene if e.gene else e.locus_tag for e in entries], dtype=object
        )
        e_start = np.array([e.start for e in entries], dtype=np.int64)
        e_end = np.array([e.end for e in entries], dtype=np.int64)
        e_strand = np.array(
            [e.strand if e.strand is not None else 0 for e in entries], dtype=np.int64
        )
        fs = e_start[entry_idx]
        fe = e_end[entry_idx]
        fstrand = e_strand[entry_idx]
        ts = tar_start[hit_idx]
        te = tar_end[hit_idx]
        tar_dir = np.where(fstrand == 1, "F", np.where(fstrand == -1, "R", None)).astype(object)
        offset = np.where(fstrand == 1, ts - fs, np.where(fstrand == -1, fe - te, 0)).astype(float)
        offset[fstrand == 0] = np.nan
        ov = np.minimum(te, fe) - np.maximum(ts, fs)
        overlap = np.maximum(ov, 0).astype(float)
        d = {k: v[hit_idx] for k, v in base_cols.items()}
        d["locus_tag"] = e_tag[entry_idx]
        d["gene"] = e_gene[entry_idx]
        d["offset"] = offset
        d["overlap"] = overlap
        d["tar_dir"] = tar_dir
        frames.append(pd.DataFrame(d))
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


def filter_offtargets_by_pam(df: pd.DataFrame) -> pd.DataFrame:
    """Drop non-targeting rows of spacers that have targets
    (reference: targets.py:542-544). Runs on factorized codes — the
    string-column unique+isin pair measured ~10 s at design scale.

    NaN-spacer rows are always kept; the reference's ``isin(targeting)``
    would also drop a NaN-spacer/NaN-target row when some other NaN-spacer
    row has a target (NaN matches NaN in isin) — a pandas quirk no real
    library can produce (spacers come from sequences), deliberately not
    reproduced."""
    if len(df) == 0:
        return df
    codes, _ = pd.factorize(df["spacer"], use_na_sentinel=True)
    has_target = np.zeros(max(int(codes.max()), 0) + 2, dtype=bool)
    t_codes = codes[df["target"].notna().to_numpy()]
    has_target[t_codes[t_codes >= 0]] = True
    drop = df["target"].isna().to_numpy() & (codes >= 0) & has_target[np.clip(codes, 0, None)]
    return df[~drop]


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


def build_notes(note: pd.DataFrame) -> np.ndarray:
    """Vectorized create_note over the whole (sites, genes, intergenic)
    frame. The count triples have tiny cardinality (~hundreds of combos at
    design scale), so dedupe the combos, format each once, and map back —
    both the row apply (~5.6 s/125k) and per-element np.char (~9 s/573k)
    measured far slower."""
    mat = note[["sites", "genes", "intergenic"]].to_numpy(dtype=np.int64)
    if len(mat) == 0:
        return np.array([], dtype=object)
    # pack the triple into one int64 when the counts fit (they always do in
    # practice; the axis=0 void-view unique measured ~1.5 s at design scale)
    b1 = int(mat[:, 1].max()).bit_length()
    b2 = int(mat[:, 2].max()).bit_length()
    if int(mat[:, 0].max()).bit_length() + b1 + b2 <= 62:
        key = (mat[:, 0] << (b1 + b2)) | (mat[:, 1] << b2) | mat[:, 2]
        uk, inv = np.unique(key, return_inverse=True)
        m2 = (np.int64(1) << b2) - 1
        m1 = (np.int64(1) << b1) - 1
        combos = np.stack([uk >> (b1 + b2), (uk >> b2) & m1, uk & m2], axis=1)
    else:  # pathological counts: fall back to the row-wise unique
        combos, inv = np.unique(mat, axis=0, return_inverse=True)
    texts = np.array(
        [
            create_note({"sites": s, "genes": g, "intergenic": i})
            for s, g, i in combos
        ],
        dtype=object,
    )
    return texts[inv]


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
    scan, annotate, assemble, postprocess. Each stage is also a span of
    the recorder (utils.profiling.span) under the call's ``targets`` span.

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
                # duplicate (name, seq) library entries are the one way the
                # row frame can carry duplicates (the name merge expands
                # them); everywhere else rows are unique by construction
                # (see postprocess docstring)
                unique_rows = identity_names or all(
                    len(v) == len(set(v)) for v in names_per_seq.values()
                )
            seq_arr = np.array(all_seqs, dtype=object)
            lens = np.fromiter(map(len, all_seqs), np.int64, len(all_seqs))
            by_len = {int(L): np.nonzero(lens == L)[0] for L in np.unique(lens)}

        frames: list[pd.DataFrame] = []
        # track hit spacers by global index — a string set over the row
        # frame (unique + set.update) iterated 600k arrow values per call
        seen_global = np.zeros(len(all_seqs), dtype=bool)
        for L, idxs in sorted(by_len.items()):
            with span("targets.prepare", phases):
                seqs = seq_arr[idxs].tolist()
                q_f = spacer_matrix(seqs)
                q_r = revcomp_matrix(q_f)
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
            with span("targets.scan", phases):
                hits_list = (
                    scan_contigs(
                        seqs, eligible, mismatches, pam, pam_direction, backend
                    )
                    if eligible  # an empty group must not build library prep
                    else []
                )
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
                    frame = build_rows(
                        contig, hits, seqs, q_f, q_r, pam, pam_direction,
                        gene_window=gene_window, insert_site=insert_site,
                    )
                if len(frame):
                    seen[hits.spacer_idx] = True  # every hit emits >=1 row
                    frames.append(frame)
            seen_global[idxs[seen]] = True

        with span("targets.assemble", phases):
            # unmapped rows for spacers with no surviving hits, then expand
            # per-name (reference gets one SAM stream per read name);
            # library-order emission
            unmapped = [
                {"spacer": all_seqs[i], "len": int(lens[i])}
                for i in np.nonzero(~seen_global)[0]
            ]
            if unmapped:
                frames.append(pd.DataFrame(unmapped))
            columns = ROW_COLUMNS if insert_site else ROW_COLUMNS[:-2]
            body = (
                pd.concat(frames, ignore_index=True)
                if frames
                # zero-entry library (API path; the CLI loader already
                # rejects empty files): an empty frame WITH the schema so
                # the name assignment/merge below and postprocess see their
                # columns
                else pd.DataFrame(columns=columns)
            )
            if identity_names:
                # identity naming (the design workload names candidates by
                # their sequence): skip the string-keyed merge (~3 s at 600k
                # rows)
                results = body.copy()
                results["name"] = results["spacer"]
            else:
                names_df = pd.DataFrame(
                    [(name, seq) for seq, names in names_per_seq.items() for name in names],
                    columns=["name", "spacer"],
                )
                results = body.merge(names_df, on="spacer", how="left")
            results = results.reindex(columns=columns)
        with span("targets.postprocess", phases):
            result = postprocess(
                results, genome, pam, pam_direction, mismatches,
                insert_site=insert_site, identity_names=identity_names,
                assume_unique_rows=unique_rows, compat_columns=compat_columns,
                gene_window=gene_window,
            )
        result.stats["profile"] = phases.summary()
    return result


def postprocess(
    results: pd.DataFrame,
    genome: Genome,
    pam: str,
    pam_direction: str,
    mismatches: int,
    insert_site: bool = False,
    identity_names: bool = False,
    assume_unique_rows: bool = False,
    compat_columns: bool = False,
    gene_window: str = "body",
) -> TargetsResult:
    """The reference's main() dataframe stage (targets.py:605-701) plus the
    summary-statistics inputs for its rich table (targets.py:716-861).

    assume_unique_rows: run_targets sets this — build_rows emits one row
    per (hit, entry-signature) with hits unique on (spacer, pos, strand)
    and unmapped rows unique per sequence, so the reference's SAM-stream
    dedup (targets.py:607) is a no-op there; a full-frame drop_duplicates
    hashes every string column (~15 arrow factorizations at design scale)."""
    seq_lens = genome.seq_lens
    if not assume_unique_rows:
        results = results.drop_duplicates()
    results = filter_offtargets_by_pam(results)

    results = results.copy()
    if len(results):
        # vectorized targets.py:624-630 (row-apply cost ~2.6 s at 125k rows).
        # NOTE: build_rows already folds origin-wrapping hits to a NEGATIVE
        # tar_start, so for pipeline frames wrap is always False here and
        # min_tar == tar_start regardless of the id-keyed length map — the
        # map is only load-bearing for reference-style external frames
        # (tar_start > tar_end wraps), which cannot carry duplicate ids
        wrap = results["tar_start"] > results["tar_end"]
        chrlen = results["chr"].map(seq_lens).astype("float64")
        results["min_tar"] = np.where(
            wrap.fillna(False), results["tar_start"] - chrlen, results["tar_start"]
        )
        # ONE lexicographic factorization of spacer/chr serves both the
        # ["chr", "min_tar", "spacer"] sort (sort=True codes order exactly
        # like the strings; NaN chr -> after the last code, NaN min_tar
        # sorts last in np.lexsort — same as sort_values' na_position) and
        # every downstream group/aggregate, which otherwise re-factorizes
        # ~600k arrow strings per call
        sp_codes, sp_uniques = pd.factorize(results["spacer"], sort=True)
        chr_codes, chr_uniques = pd.factorize(results["chr"], sort=True)
        order = np.lexsort((
            sp_codes,
            np.asarray(results["min_tar"], dtype=np.float64),
            np.where(chr_codes < 0, len(chr_uniques), chr_codes),
        ))
        results = results.iloc[order]
        results["_sp"] = sp_codes[order]
        results["_chr"] = chr_codes[order]
        n_sp = len(sp_uniques)
    else:
        results["_sp"] = np.zeros(0, dtype=np.int64)
        results["_chr"] = np.zeros(0, dtype=np.int64)
        n_sp = 0
    if identity_names:
        # name == spacer: one name per spacer, and dropping the name column
        # cannot create duplicate rows — skip two 600k-string-row dedups
        spacers_seen_arr = pd.Series(1, index=np.arange(n_sp))
        results = results.drop("name", axis=1)
    else:
        spacers_seen_arr = (
            results[["name", "_sp"]].drop_duplicates().groupby("_sp").size()
        )
        results = results.drop("name", axis=1).drop_duplicates()
    sp = results["_sp"].to_numpy()
    # site identity = (chr, coords) pair as one int; NaN target rows get no
    # site (matches the string "chr_coords" site of targets.py:640-667).
    # Codes stay as helper columns so the summary stats run on ints (each
    # string-column nunique/groupby re-factorizes ~600k arrow strings);
    # null → -1 sentinel
    chr_c = results["_chr"].to_numpy()
    coo_c, coo_u = pd.factorize(results["coords"])
    results["_coo"] = coo_c
    results["_lt"], _ = pd.factorize(results["locus_tag"])
    has_t = results["target"].notna().to_numpy()
    site_id = np.where(has_t, chr_c * (len(coo_u) + 1) + coo_c, -1)
    tgt = pd.DataFrame({"_sp": sp[has_t], "_site": site_id[has_t]})
    site_counts_arr = tgt.drop_duplicates().groupby("_sp").size()
    gene_counts_arr = (
        pd.Series(sp[results["locus_tag"].notna().to_numpy()]).value_counts()
    )
    intergenic_counts_arr = pd.Series(
        sp[(results["locus_tag"].isna() & results["target"].notna()).to_numpy()]
    ).value_counts()

    spacer_lengths = set(results["len"].dropna().astype(int))
    spacer_len_range = (
        str(next(iter(spacer_lengths)))
        if len(spacer_lengths) == 1
        else ",".join(str(x) for x in sorted(spacer_lengths))
    )

    note = pd.DataFrame(
        {
            "count": spacers_seen_arr,
            "sites": site_counts_arr,
            "genes": gene_counts_arr,
            "intergenic": intergenic_counts_arr,
        }
    )  # index = spacer codes (spacers_seen covers every spacer in results)
    note = note.fillna(0).astype(int)
    note["note"] = build_notes(note)
    results = results.merge(note, left_on="_sp", right_index=True, how="left")

    column_order = ["spacer", "locus_tag", "gene", "chr"]
    if not (results["count"] == 1).all():
        column_order.append("count")
    if not (results["pam"].isnull().all() or results["pam"].nunique() == 1):
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


def _n_uniq_nonneg(codes: pd.Series) -> int:
    """Distinct non-sentinel factorized codes (≡ .nunique() on the string
    column the codes were factorized from, which excludes nulls)."""
    arr = codes.to_numpy()
    return int(np.unique(arr[arr >= 0]).size)


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
        # every aggregate below runs on postprocess-time factorized codes
        # ("_sp"/"_chr"/"_coo"/"_lt", null → -1): string nunique/groupby
        # re-factorizes ~600k arrow strings per call
        "chromosomes_targeted": _n_uniq_nonneg(results["_chr"]),
        "genes_targeted": _n_uniq_nonneg(results["_lt"]),
        "overlapping_genes_targeted": _n_uniq_nonneg(
            results.loc[results["genes"] > 1, "_lt"]
        ),
        "unique_barcodes": int(results["_sp"].nunique()),
        "intergenic_barcodes": _n_uniq_nonneg(
            results.loc[
                (results["_lt"].to_numpy() < 0) & (results["_chr"].to_numpy() >= 0),
                "_sp",
            ]
        ),
        "off_target_barcodes": int(
            results[results["target"].notnull()]
            .groupby("_sp")["_coo"]
            .nunique()  # ≡ apply(set).apply(len), without per-group Python
            .gt(1)
            .sum()
        ),
        "non_targeting_barcodes": int(
            results.loc[results["target"].isnull(), "_sp"].nunique()
        ),
    }
    if "mismatches" in final_results.columns:
        # same rows as final_results, grouped on codes instead of strings
        per_mm = results.groupby(["mismatches"])["_sp"].nunique()
        stats["spacers_per_mismatch"] = {int(k): int(v) for k, v in per_mm.items()}
    return stats


def write_output(result: TargetsResult, stream, as_json: bool = False) -> None:
    """TSV (default) or JSON records, reproducing targets.py:696-701."""
    if as_json:
        stream.write(result.table.to_json(orient="records", indent=4))
        stream.write("\n")
    else:
        result.table.to_csv(stream, sep="\t", index=False, na_rep="None")
