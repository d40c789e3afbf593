"""Genome model: contigs, packed codes, gene/locus intervals, scan arrays.

Replaces the reference's per-base ``locus_map`` dict (targets.py:76-165) and
100 kb "topological overhang" linearization (targets.py:35-56) with:

  - interval arrays per contig (vectorized join via sorted starts +
    searchsorted, see :mod:`barcoder_tpu.core.locus`);
  - exact wrap-around halos sized to the scan window (left ``|pam|``, right
    ``L + |pam| - 1``) instead of a fixed 100 kb copy — every canonical start
    ``p ∈ [0, len)`` sees its full window and PAM context exactly once, so no
    duplicate-hit folding/dedup pass is needed.

Reference locus-map semantics reproduced exactly (targets.py:102-163):

  - origin-wrapping genes (CompoundLocation with a part at 0 and a part at
    len) get one *adjusted* interval [adj_start, adj_end) with
    adj_end = end_of_start_part + len;
  - every other gene contributes one interval per location part;
  - for the hit→gene join, only the portion of each interval below ``len``
    can match (reference folds hit coords to (-len, len) before the per-base
    lookup, so the +len overhang duplicates and the ≥len tail of wrapped
    genes are unreachable — we clip instead of duplicating);
  - offset/overlap math uses the *unclipped* adjusted interval bounds,
    matching targets.py:205-216 fed from the stored entries.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..seqio.genbank import CompoundLocation, GenBankRecord, parse_genbank
from ..seqio.snapgene import parse_snapgene, read_snapgene_dir
from .encode import encode

OVERHANG = 100_000  # reference's circular-overhang constant (targets.py:44)


@dataclass
class LocusEntry:
    """One joinable gene occurrence (one location part, or one adjusted
    wrapped-gene interval)."""

    locus_tag: str | None
    gene: str | None
    start: int  # adjusted feature start (may exceed len for wrapped genes)
    end: int  # adjusted feature end
    strand: int | None
    join_start: int  # clip(start, 0, len): the joinable portion
    join_end: int  # clip(end, 0, len)


@dataclass
class Contig:
    id: str
    length: int
    codes: np.ndarray  # int8 base codes
    seq: str
    topology: str | None = None
    organism: str | None = None
    description: str = ""
    gene_count: int = 0
    locus_entries: list[LocusEntry] = field(default_factory=list)
    features: list = field(default_factory=list)  # retained GenBank features

    # lazily-built join indexes
    _locus_index: object = None
    _upstream_index: object = None

    def __post_init__(self):
        # the device caches and disk-artifact keys digest ``codes`` by
        # content, memoized per array object (ops.pallas_scan._content_digest)
        # — freeze it so in-place mutation is an error rather than a silent
        # stale-cache hazard. When the array is a VIEW of (or shares) a
        # still-writable base, freezing the view is not enough (mutation
        # through the base would silently stale the digest) and flipping
        # the caller's flag in place is a visible side effect — take a
        # frozen private copy instead (ADVICE r4).
        # An OWNING array is frozen in place (documented side effect on the
        # caller's object; a copy would double peak memory at chromosome
        # scale); a view is copied because freezing it cannot stop
        # mutation through its base.
        if isinstance(self.codes, np.ndarray):
            arr = self.codes
            if arr.base is not None:
                bflags = getattr(arr.base, "flags", None)
                if arr.flags.writeable or (bflags is not None and bflags.writeable):
                    arr = arr.copy()
            if arr.flags.writeable:
                arr.flags.writeable = False
            self.codes = arr

    @property
    def circular(self) -> bool:
        return self.topology == "circular"

    def locus_index(self):
        """Gene-body interval index (targets.py locus-map semantics)."""
        if self._locus_index is None:
            from .locus import LocusIndex

            self._locus_index = LocusIndex(self.locus_entries)
        return self._locus_index

    def upstream_locus_index(self):
        """Promoter-window interval index (targets_in_upstream.py:47-171
        semantics)."""
        if self._upstream_index is None:
            from .locus import LocusIndex

            self._upstream_index = LocusIndex(build_upstream_entries(self))
        return self._upstream_index

    def fetch_codes(self, start: int, end: int) -> np.ndarray:
        """Fetch codes[start:end] with circular wraparound (start may be
        negative, end may exceed length for circular contigs)."""
        n = self.length
        if 0 <= start and end <= n:
            return self.codes[start:end]
        if not self.circular or n == 0:
            # n == 0: the modular wrap below would divide by zero
            raise IndexError(f"fetch [{start},{end}) out of bounds for linear contig of length {n}")
        idx = np.arange(start, end) % n
        return self.codes[idx]

def _build_locus_entries(record: GenBankRecord) -> tuple[list[LocusEntry], int]:
    """Translate gene features into LocusEntry intervals with the reference's
    adjusted-coordinate semantics (targets.py:96-163)."""
    entries: list[LocusEntry] = []
    n = len(record.seq)
    gene_count = 0
    for feature in record.features:
        if feature.type != "gene":
            continue
        gene_count += 1
        locus_tag = feature.qualifier("locus_tag")
        gene_name = feature.qualifier("gene")
        loc = feature.location
        parts = loc.parts
        is_wrapped = isinstance(loc, CompoundLocation) and any(
            p.start == 0 or p.end == n for p in parts
        )
        if is_wrapped:
            end_seg = next((p for p in parts if p.end == n), None)
            start_seg = next((p for p in parts if p.start == 0), None)
            if end_seg is None or start_seg is None:
                # reference would raise StopIteration; treat as normal parts
                is_wrapped = False
            else:
                adj_start = int(end_seg.start)
                adj_end = int(start_seg.end) + n
                entries.append(
                    LocusEntry(
                        locus_tag,
                        gene_name,
                        adj_start,
                        adj_end,
                        loc.strand,
                        join_start=max(0, min(adj_start, n)),
                        join_end=max(0, min(adj_end, n)),
                    )
                )
        if not is_wrapped:
            for part in parts:
                s, e = int(part.start), int(part.end)
                entries.append(
                    LocusEntry(
                        locus_tag,
                        gene_name,
                        s,
                        e,
                        loc.strand,
                        join_start=max(0, min(s, n)),
                        join_end=max(0, min(e, n)),
                    )
                )
    return entries, gene_count


def build_upstream_entries(contig: "Contig") -> list[LocusEntry]:
    """Promoter-window locus entries per gene occurrence, reproducing
    create_upstream_locus_map (targets_in_upstream.py:47-171):

      - origin-wrapping genes: strand +1 → window [adj_start-205,
        adj_start-95); strand -1 → [adj_end+95, adj_end+205);
      - all other genes, per location part: strand +1 → [start-205,
        start+95); strand -1 → [end+95, end+205) (note the reference's
        asymmetric +95 upper bound for normal + strand genes);
      - stored feature coords remain the gene's own (adjusted) interval, so
        offset/overlap math is unchanged;
      - windows may start below 0 — those positions are reachable by
        origin-wrapping hit queries, exactly like the reference's negative
        dict keys; portions at or beyond ``len`` are unreachable and clipped.

    Genes with no strand are skipped (the reference would crash on them,
    targets_in_upstream.py:96-136).
    """
    n = contig.length
    out: list[LocusEntry] = []
    for e in contig.locus_entries:
        if e.strand == 1:
            ws, we = e.start - 205, (e.start - 95 if e.end > n else e.start + 95)
            # wrapped genes (end > n) use the -95 bound; normal parts +95
        elif e.strand == -1:
            ws, we = e.end + 95, e.end + 205
        else:
            continue
        out.append(
            LocusEntry(
                e.locus_tag, e.gene, e.start, e.end, e.strand,
                join_start=ws,
                join_end=min(we, n),
            )
        )
    return out


def contig_from_record(record: GenBankRecord) -> Contig:
    entries, gene_count = _build_locus_entries(record)
    return Contig(
        id=record.id,
        length=len(record.seq),
        codes=encode(record.seq),
        seq=record.seq,
        topology=record.topology,
        organism=record.organism,
        description=record.description,
        gene_count=gene_count,
        locus_entries=entries,
        features=list(record.features),
    )


@dataclass
class Genome:
    contigs: list[Contig]
    source: str = ""

    @classmethod
    def from_genbank(cls, path: str) -> "Genome":
        return cls([contig_from_record(r) for r in parse_genbank(path)], source=path)

    @classmethod
    def from_snapgene(cls, path: str) -> "Genome":
        if os.path.isdir(path):
            records = read_snapgene_dir(path)
        else:
            records = [parse_snapgene(path)]
        return cls([contig_from_record(r) for r in records], source=path)

    @classmethod
    def from_fasta(cls, path: str, topology: str = "linear") -> "Genome":
        from ..seqio.fasta import iter_fasta

        contigs = []
        for rid, desc, seq in iter_fasta(path):
            seq = seq.upper()
            contigs.append(
                Contig(
                    id=rid,
                    length=len(seq),
                    codes=encode(seq),
                    seq=seq,
                    topology=topology,
                    description=desc,
                )
            )
        return cls(contigs, source=path)

    @classmethod
    def load(cls, path: str) -> "Genome":
        """Dispatch on extension: .gb/.gbk/.genbank (+.gz), .dna, directory of
        .dna, else FASTA."""
        if os.path.isdir(path):
            return cls.from_snapgene(path)
        base = path[:-3] if path.endswith(".gz") else path
        if base.endswith((".gb", ".gbk", ".gbff", ".genbank")):
            return cls.from_genbank(path)
        if base.endswith(".dna"):
            return cls.from_snapgene(path)
        return cls.from_fasta(path)

    # --- reference-compatible summary dicts (targets.py:77-165) ---
    @property
    def organisms(self) -> dict:
        return {c.id: c.organism for c in self.contigs}

    @property
    def seq_lens(self) -> dict:
        return {c.id: c.length for c in self.contigs}

    @property
    def topologies(self) -> dict:
        return {c.id: c.topology for c in self.contigs}

    @property
    def all_genes(self) -> dict:
        return {c.id: c.gene_count for c in self.contigs}

    def ambiguity_stats(self, gene_window: str = "body") -> tuple[int, int]:
        """(n_ambiguous_coordinates, n_ambiguous_locus_tags): folded genome
        positions covered by >1 locus entry and the tags touching them
        (reference: targets.py:788-797; for gene_window="upstream" the
        PROMOTER-WINDOW map is counted instead, matching
        targets_in_upstream.py:786-807 — body overlap and window overlap
        are independent, so the upstream tool's stats differ).

        Computed on the unfolded axis like the reference's dict keys, then
        folded. Genome-level and input-invariant, so cached per mode
        (postprocess calls it per run; ~1 s at E. coli scale).

        The cache assumes a Genome is IMMUTABLE after construction — the
        invariant the whole package relies on (the device scan caches key
        on contig content for the same reason). Mutating `contigs` /
        `locus_entries` in place after the first call returns stale stats;
        build a new Genome instead."""
        cache = getattr(self, "_ambiguity_cache2", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_ambiguity_cache2", cache)
        if gene_window in cache:
            return cache[gene_window]
        if gene_window == "upstream":
            stats = self._upstream_ambiguity_stats()
            cache[gene_window] = stats
            return stats
        total_coords = 0
        tags: set = set()
        for c in self.contigs:
            overhang = OVERHANG if c.circular else 0
            max_end = max((e.end for e in c.locus_entries), default=0)
            axis_len = c.length + max(
                min(overhang, c.length), max_end - c.length, 0
            )
            cov = np.zeros(axis_len + 1, dtype=np.int32)
            # Reproduce the reference's key set exactly, including its
            # ORDER-DEPENDENT overhang duplication (targets.py:149-163):
            # non-wrapped genes duplicate positions p in
            # [overhang_continue, overhang) to p + len, where
            # overhang_continue is the post-origin arm end of the most
            # recently PROCESSED wrapped gene (0 before any) — so a gene
            # earlier in the file than the wrapped gene duplicates into the
            # wrapped gene's unfolded keys and collides, a later one does
            # not. Wrapped genes themselves key [adj_start, adj_end).
            oc = 0
            for e in c.locus_entries:
                cov[min(e.start, axis_len)] += 1
                cov[min(e.end, axis_len)] -= 1
                if e.end > c.length:  # wrapped (adjusted past the origin)
                    oc = e.end - c.length
                else:
                    dup_lo = max(e.start, oc)
                    dup_hi = min(e.end, overhang)
                    if dup_hi > dup_lo:
                        cov[min(dup_lo + c.length, axis_len)] += 1
                        cov[min(dup_hi + c.length, axis_len)] -= 1
            cov = np.cumsum(cov[:-1])
            amb_pos = np.nonzero(cov > 1)[0]
            folded = np.unique(amb_pos % c.length)
            total_coords += len(folded)
            if len(folded):
                # the reference resolves tags by looking the FOLDED position
                # up in the locus map (targets.py:793-797), i.e. entries
                # whose direct key range contains it — that is the joinable
                # interval (binary search per entry)
                lo = np.searchsorted(folded, [e.join_start for e in c.locus_entries])
                hi = np.searchsorted(folded, [e.join_end for e in c.locus_entries])
                for e, touched in zip(c.locus_entries, hi > lo):
                    if touched and e.join_end > e.join_start:
                        tags.add(e.locus_tag)
        cache["body"] = (total_coords, len(tags))
        return total_coords, len(tags)

    def _upstream_ambiguity_stats(self) -> tuple[int, int]:
        """Promoter-window ambiguity (targets_in_upstream.py:786-796): raw
        window keys (negative and past-length allowed) covered by >1 entry,
        folded % length; tags are the entries whose window contains a
        folded ambiguous position (the reference looks the FOLDED position
        up in its raw-key map — same folded-lookup treatment as the body
        stats). Windows here are the UNCLIPPED reference ranges, not the
        join-clipped ones of build_upstream_entries: overlap past the
        contig length still folds into ambiguous coordinates."""
        total_coords = 0
        tags: set = set()
        for c in self.contigs:
            n = c.length
            wins: list[tuple[int, int, str]] = []
            for e in c.locus_entries:
                if e.strand == 1:
                    ws = e.start - 205
                    we = e.start - 95 if e.end > n else e.start + 95
                elif e.strand == -1:
                    ws, we = e.end + 95, e.end + 205
                else:
                    continue  # strandless genes: skipped (the reference crashes)
                wins.append((ws, we, e.locus_tag))
            if not wins or n == 0:
                continue
            lo = min(ws for ws, _we, _t in wins)
            hi = max(we for _ws, we, _t in wins)
            if hi <= lo:
                continue
            cov = np.zeros(hi - lo + 1, dtype=np.int32)
            for ws, we, _t in wins:
                cov[ws - lo] += 1
                cov[we - lo] -= 1
            amb_raw = np.nonzero(np.cumsum(cov[:-1]) > 1)[0] + lo
            folded = np.unique(amb_raw % n)
            total_coords += len(folded)
            if len(folded):
                lo_i = np.searchsorted(folded, [w[0] for w in wins])
                hi_i = np.searchsorted(folded, [w[1] for w in wins])
                for (ws, we, tag), touched in zip(wins, hi_i > lo_i):
                    if touched:
                        tags.add(tag)
        return total_coords, len(tags)
