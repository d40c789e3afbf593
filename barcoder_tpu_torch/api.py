"""High-level class API — the framework's equivalent of the reference's
SOLID-style layer (GenBankParser / GuideFinder / BowtieRunner / PySamParser /
PAMFinder / CRISPRiLibrary demonstrated in testing_grounds.py:16-43).

The flow maps 1:1:

    reference                           barcoder_tpu
    ---------                           ------------
    GenBankParser("g.gb")               Genome.load("g.gb")
    GuideFinder(...).find_guides...     GuideFinder(genome, pam, dir, len)
    BarCodeLibrary(barcodes=guides)     BarcodeLibrary.from_list(guides)
    with BowtieRunner() as bt: ...      ScanRunner(genome).align(barcodes, v)
    PySamParser(sam).ranges             ...returns the same interval frame
    ranges.join(genbank.ranges)         ScanRunner.align(..., join_features=True)
    CRISPRiLibrary(df, pam_finder)      CRISPRiLibrary(df, pam_finder)

Differences: alignment runs on the device scan engine instead of a Bowtie
subprocess + SAM round-trip, and the interval join is a vectorized
searchsorted join instead of PyRanges.
"""

from __future__ import annotations

import re

import numpy as np
import pandas as pd

from .core.encode import COMP_ASCII, encode, revcomp
from .core.genome import Genome
from .ops.scan import scan_contig
from .ops.types import STRAND_R
from .seqio.library import BarcodeLibrary  # re-export for API parity
from .utils.logger import Logger

# schemas of ScanRunner.align / .join_features — pinned so EMPTY results
# keep their columns (a columnless frame crashed CRISPRiLibrary)
_ALIGN_COLUMNS = (
    "Chromosome", "Start", "End", "Mapped", "Strand", "Barcode", "Mismatches",
)
_JOIN_COLUMNS = ["Start_b", "End_b", "Strand_b", "Locus_Tag", "Gene", "Type"]

__all__ = ["Genome", "BarcodeLibrary", "GuideFinder", "PAMFinder", "ScanRunner", "CRISPRiLibrary"]


class GuideFinder:
    """Find guide sequences adjacent to PAM matches (behavioral spec:
    PAMProcessor.py:27-57 — same outputs, vectorized match search).

    Output semantics match the reference's regex enumeration exactly,
    including its quirks: matches are NON-overlapping left-to-right
    (``re.finditer`` resumes at match end, so "GGG" yields one "GG" match,
    not two) and guides at a strand edge come back truncated (possibly
    empty). ``pipeline.design.find_candidate_guides`` is the engine-grade
    enumerator without these quirks; this class is the API-parity surface."""

    def __init__(self, genome: Genome, pam: str, direction: str, length: int):
        self.genome = genome
        self.pam = pam.replace("N", "[ATCG]")  # regex form, kept for parity
        self._pam_raw = pam
        self.direction = direction
        self.length = length
        if direction not in ("upstream", "downstream"):
            raise ValueError("Direction must be 'upstream' or 'downstream'")

    def _match_starts(self, seq: str) -> np.ndarray:
        """Start positions of non-overlapping PAM matches, left to right.

        Computed as a vectorized per-position character-class AND over the
        code array, then a greedy sparse pass for finditer's non-overlap
        rule (iterates matches, ~n/4^|pam| of positions, not positions)."""
        pam = self._pam_raw
        plen = len(pam)
        if plen == 0 or len(seq) < plen or set(pam) - set("ACGTN"):
            # empty/non-IUPAC patterns: defer to the regex engine
            return np.array([m.start() for m in re.finditer(self.pam, seq)], np.int64)
        codes = encode(seq)
        n_pos = len(codes) - plen + 1
        m = np.ones(n_pos, dtype=bool)
        for j, ch in enumerate(pam):
            cj = codes[j : j + n_pos]
            # genomic N matches nothing, as in the reference's [ATCG]
            m &= (cj < 4) if ch == "N" else (cj == int(encode(ch)[0]))
        cand = np.nonzero(m)[0]
        if plen == 1 or not len(cand):
            return cand
        keep = []
        last_end = -1
        for p in cand:
            if p >= last_end:
                keep.append(p)
                last_end = p + plen
        return np.asarray(keep, dtype=np.int64)

    def find_guides_from_pam(self) -> list[str]:
        """Guides adjacent to every PAM site on both strand strings of every
        contig ('downstream' → the guide precedes the PAM)."""
        plen = len(self._pam_raw)
        guides: list[str] = []
        for contig in self.genome.contigs:
            for seq in (contig.seq, revcomp(contig.seq)):
                starts = self._match_starts(seq)
                if self.direction == "downstream":
                    guides.extend(seq[max(0, s - self.length) : s] for s in starts)
                else:
                    guides.extend(
                        seq[s + plen : s + plen + self.length] for s in starts
                    )
        return guides


class PAMFinder:
    """Row-wise PAM extraction + matching over interval frames
    (reference: PAMProcessor.py:60-97)."""

    def __init__(self, genome: Genome, pam: str, direction: str):
        self.genome = genome
        self.pam = pam.replace("N", "[ATCG]")
        self.pam_length = len(pam)
        self.direction = direction
        self._by_id = {c.id: c for c in genome.contigs}

    @staticmethod
    def get_strand(strand_symbol) -> int:
        """Reference strand normalization (PAMProcessor.py:16-24):
        'fwd'/'forward' count as +1 and unrecognized symbols RAISE —
        silently treating garbage as minus strand yields plausible-looking
        wrong PAM annotations (r5 review)."""
        s = str(strand_symbol).lower().strip()
        if s in ("+", "1", "+1", "fwd", "forward"):
            return 1
        if s in ("-", "-1", "rev", "reverse"):
            return -1
        raise ValueError(f"Unrecognized strand symbol: {strand_symbol}")

    def get_pam_seq(self, row) -> str:
        contig = self._by_id[row.Chromosome]
        strand = self.get_strand(row.Strand)
        if strand == 1:
            window = contig.seq[row.End : row.End + self.pam_length]
        else:
            # plain Python slice, preserving the reference's negative-index
            # quirk (PAMProcessor.py:73-75): Start < pam_length makes the
            # start index negative and the slice EMPTY, not truncated
            window = contig.seq[row.Start - self.pam_length : row.Start]
        if strand == -1:
            window = revcomp(window)
        return window

    def pam_matches(self, sequence: str) -> bool:
        return bool(re.search(self.pam, sequence))


class ScanRunner(Logger):
    """Alignment engine with the BowtieRunner role (BowtieRunner.py:13-150):
    align a barcode set against the genome at <= v mismatches and return the
    reference's interval-frame schema (PySamParser.py:21-52) —
    Chromosome/Start/End/Mapped/Strand/Barcode/Mismatches — optionally
    joined with the genome's feature intervals (the
    ``sam.ranges.join(genbank.ranges)`` step, testing_grounds.py:38)."""

    def __init__(self, genome: Genome, backend: str = "auto"):
        super().__init__()
        self.genome = genome
        self.backend = backend

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def align(
        self,
        barcodes,
        num_mismatches: int = 0,
        pam: str = "",
        pam_direction: str = "downstream",
        join_features: bool = False,
        sam_path: str | None = None,
    ) -> pd.DataFrame:
        """sam_path: also export the (pre-join) alignments as SAM — the
        interop surface the reference gets from Bowtie's own output
        (BowtieRunner.align writes a .sam; PySamParser re-reads it)."""
        seqs = sorted(set(barcodes)) if not isinstance(barcodes, list) else list(dict.fromkeys(barcodes))
        by_len: dict[int, list[str]] = {}
        for s in seqs:
            by_len.setdefault(len(s), []).append(s)
        rows = []
        mapped_seqs = set()
        for L, group in sorted(by_len.items()):
            for contig in self.genome.contigs:
                hits = scan_contig(group, contig, num_mismatches, pam, pam_direction, self.backend)
                for i in range(len(hits)):
                    seq = group[int(hits.spacer_idx[i])]
                    p = int(hits.pos[i])
                    rows.append(
                        {
                            "Chromosome": contig.id,
                            "Start": p,
                            "End": p + L,
                            "Mapped": True,
                            "Strand": "-" if hits.strand[i] == STRAND_R else "+",
                            "Barcode": seq,
                            "Mismatches": int(hits.mismatches[i]),
                        }
                    )
                    mapped_seqs.add(seq)
        for seq in seqs:
            if seq not in mapped_seqs:
                rows.append(
                    {
                        "Chromosome": None,
                        "Start": -1,
                        "End": -1,
                        "Mapped": False,
                        "Strand": ".",
                        "Barcode": seq,
                        "Mismatches": 0,
                    }
                )
        df = pd.DataFrame(rows, columns=_ALIGN_COLUMNS)
        if sam_path:
            from .seqio.sam import write_sam

            with open(sam_path, "w") as f:
                write_sam(df, f, seq_lens=self.genome.seq_lens)
        if join_features:
            df = self.join_features(df)
        return df

    def feature_frame(self) -> pd.DataFrame:
        """Genome features as an interval frame
        (reference: GenBankParser.ranges, GenBankParser.py:68-103 — source +
        gene features, one row per location part)."""
        data = []
        for contig in self.genome.contigs:
            data.append(
                {
                    "Chromosome": contig.id,
                    "Start": 0,
                    "End": contig.length,
                    "Strand": "+",
                    "Locus_Tag": None,
                    "Gene": None,
                    "Type": "source",
                }
            )
            for feat in contig.features:
                if feat.type != "gene":
                    continue  # source rows are synthesized above from
                    # contig bounds; other feature types aren't joined
                for part in feat.location.parts:
                    data.append(
                        {
                            "Chromosome": contig.id,
                            "Start": int(part.start),
                            "End": int(part.end),
                            "Strand": "+" if part.strand == 1 else "-" if part.strand == -1 else ".",
                            "Locus_Tag": feat.qualifier("locus_tag"),
                            "Gene": feat.qualifier("gene"),
                            "Type": feat.type,
                        }
                    )
        return pd.DataFrame(data)

    def join_features(self, align_df: pd.DataFrame) -> pd.DataFrame:
        """Interval join of alignments × features (PyRanges .join
        equivalent): one output row per overlapping pair, feature columns
        suffixed _b like PyRanges does.

        Fully vectorized: candidate pairs come from a searchsorted window
        over start-sorted features, expanded with repeat/cumsum indexing,
        then overlap-filtered — one frame build per chromosome, no per-row
        Python (the per-pair ``iloc``/``to_dict`` loop this replaces
        measured ~1k rows/s)."""
        feats = self.feature_frame()
        out_frames = []
        mapped = align_df[align_df.Mapped] if len(align_df) else align_df
        for chrom, adf in mapped.groupby("Chromosome"):
            fdf = feats[feats.Chromosome == chrom].reset_index(drop=True)
            if not len(fdf):
                continue
            # contig-spanning 'source' rows overlap EVERY alignment; keeping
            # them in the searchsorted window made max_len the contig length
            # and lo always 0 — candidate pairs scaled as n_align x n_feat
            # (r5 review: ~2e8 transient pairs at E. coli scale). Pair them
            # directly and window-join only the gene rows.
            is_src = (fdf.Type == "source").to_numpy()
            pieces = []
            n_src = int(is_src.sum())
            if n_src:
                src_idx = np.flatnonzero(is_src)
                rep = np.repeat(np.arange(len(adf)), n_src)
                pieces.append((rep, np.tile(src_idx, len(adf))))
            gene_idx = np.flatnonzero(~is_src)
            if len(gene_idx):
                starts_g = fdf.Start.to_numpy()[gene_idx]
                ends_g = fdf.End.to_numpy()[gene_idx]
                order = np.argsort(starts_g, kind="stable")
                s_sorted = starts_g[order]
                max_len = int((ends_g - starts_g).max())
                a = adf.Start.to_numpy()
                b = adf.End.to_numpy()
                lo = np.searchsorted(s_sorted, a - max_len)
                hi = np.maximum(np.searchsorted(s_sorted, b), lo)
                cnt = hi - lo
                total = int(cnt.sum())
                if total:
                    # flatten all [lo_i, hi_i) ranges: pair p -> (row, slot)
                    rep = np.repeat(np.arange(len(adf)), cnt)
                    offsets = np.cumsum(cnt) - cnt
                    slot = (
                        np.arange(total) - np.repeat(offsets, cnt)
                        + np.repeat(lo, cnt)
                    )
                    fi = gene_idx[order[slot]]
                    starts = fdf.Start.to_numpy()
                    ends = fdf.End.to_numpy()
                    keep = (starts[fi] < b[rep]) & (ends[fi] > a[rep])
                    pieces.append((rep[keep], fi[keep]))
            if not pieces:
                continue
            rep = np.concatenate([p[0] for p in pieces])
            fi = np.concatenate([p[1] for p in pieces])
            # feature-frame order per alignment (source first, genes by
            # position) like the pre-split single-window join emitted
            sort = np.lexsort((fi, rep))
            rep, fi = rep[sort], fi[sort]
            if not len(rep):
                continue
            starts = fdf.Start.to_numpy()
            ends = fdf.End.to_numpy()
            joined = adf.iloc[rep].reset_index(drop=True)
            joined["Start_b"] = starts[fi]
            joined["End_b"] = ends[fi]
            joined["Strand_b"] = fdf.Strand.to_numpy()[fi]
            joined["Locus_Tag"] = fdf.Locus_Tag.to_numpy()[fi]
            joined["Gene"] = fdf.Gene.to_numpy()[fi]
            joined["Type"] = fdf.Type.to_numpy()[fi]
            out_frames.append(joined)
        if not out_frames:
            # schema'd empty frame: downstream consumers (CRISPRiLibrary)
            # index these columns and crashed on a columnless frame
            empty = pd.DataFrame(columns=list(_ALIGN_COLUMNS) + _JOIN_COLUMNS)
            return empty
        return pd.concat(out_frames, ignore_index=True)


class CRISPRiLibrary:
    """Guide-library filters over the joined frame (behavioral spec:
    CRISPRiLibrary.py:4-120 — same frames out, column-vectorized).

    Exposed frames, in dependency order:
      source_unique_targets — chromosome-level ('source' rows) targets,
          PAM-targeting, first row per barcode;
      mapped_targets — feature rows with strand-aware Offset from feature
          start and clamped Overlap;
      unique_targets — mapped rows whose barcode is chromosome-unique,
          position-sorted;
      unambiguous_targets — first feature row per barcode of those (drops
          overlapping-gene multi-rows)."""

    def __init__(self, targets_df: pd.DataFrame, pam_finder: PAMFinder):
        self.targets_df = targets_df.copy()
        self.pam_finder = pam_finder
        self._annotate_targets()
        self.source_unique_targets = self._get_source_unique_targets()
        self.mapped_targets = self._get_mapped_targets()
        self.unique_targets = self._get_unique_targets()
        self.unambiguous_targets = self._get_unambiguous_targets()

    def _annotate_targets(self):
        """PAM + Targeting columns: windows gathered per chromosome as one
        (rows, pam_len) byte matrix (revcomp'd in bulk on the minus strand),
        matched once per UNIQUE window string instead of once per row."""
        df = self.targets_df
        plen = self.pam_finder.pam_length
        pams = np.full(len(df), "", dtype=object)
        for chrom, idx in {} if plen == 0 else df.groupby("Chromosome").indices.items():
            contig = self.pam_finder._by_id[chrom]
            seqb = np.frombuffer(contig.seq.encode("ascii"), np.uint8)
            n = len(seqb)
            start = df["Start"].to_numpy()[idx].astype(np.int64)
            end = df["End"].to_numpy()[idx].astype(np.int64)
            plus = np.isin(df["Strand"].astype(str).to_numpy()[idx], ["+", "1", "+1"])
            lo = np.where(plus, end, np.maximum(start - plen, 0))
            hi = np.where(plus, np.minimum(end + plen, n), start)
            cols = lo[:, None] + np.arange(plen)[None, :]
            valid = cols < hi[:, None]
            chars = seqb[np.clip(cols, 0, n - 1)]
            chars[~valid] = 0
            # minus strand reads revcomp'd: complement bytes, reverse columns
            minus = ~plus
            chars[minus] = COMP_ASCII[chars[minus]][:, ::-1]
            full = valid.all(axis=1)
            strs = np.ascontiguousarray(chars).view(f"S{plen}").ravel().astype(str)
            pams[idx[full]] = strs[full]
            for k in np.nonzero(~full)[0]:  # truncated boundary windows, rare
                row_bytes = chars[k][chars[k] != 0]
                pams[idx[k]] = row_bytes.tobytes().decode("ascii")
        df["PAM"] = pams
        # regex once per unique window (windows have tiny cardinality)
        codes, uniq = pd.factorize(df["PAM"])
        pat = re.compile(self.pam_finder.pam)
        uniq_match = np.array([bool(pat.search(u)) for u in uniq], dtype=bool)
        df["Targeting"] = uniq_match[codes]

    def _get_source_unique_targets(self):
        df = self.targets_df
        sel = (df["Type"] == "source") & df["Targeting"] & df["Mapped"]
        src = df[sel]
        return src[~src.duplicated(subset=["Barcode"])].reset_index(drop=True)

    def _get_mapped_targets(self):
        df = self.targets_df
        sel = (df["Type"] != "source") & df["Targeting"] & df["Mapped"]
        mapped = df[sel].reset_index(drop=True)
        start = mapped["Start"].to_numpy(dtype=np.int64, copy=True)
        end = mapped["End"].to_numpy(dtype=np.int64)
        start_b = mapped["Start_b"].to_numpy(dtype=np.int64)
        end_b = mapped["End_b"].to_numpy(dtype=np.int64)
        strand_b = mapped["Strand_b"].astype(str).to_numpy()
        off = np.where(strand_b == "+", start - start_b, end_b - end)
        known = (strand_b == "+") | (strand_b == "-")
        overlap = np.maximum(np.minimum(end, end_b) - np.maximum(start, start_b), 0)
        if known.all():
            mapped["Offset"] = off
        else:  # unstranded features carry a null offset
            mapped["Offset"] = pd.array(off, dtype="Int64")
            mapped.loc[~known, "Offset"] = pd.NA
        mapped["Overlap"] = overlap
        return mapped

    def _get_unique_targets(self):
        mapped = self.mapped_targets
        uniq = mapped[mapped["Barcode"].isin(self.source_unique_targets.Barcode)]
        return uniq.sort_values(["Chromosome", "Start", "End"]).reset_index(drop=True)

    def _get_unambiguous_targets(self):
        return self.unique_targets[
            ~self.unique_targets.duplicated(subset=["Barcode"])
        ]
