"""Seeded generators of the benchmark's inputs, frozen here so that later
edits to the program or to its smoke script cannot change the work a cell
does. They are copies, reshaped to return plain arrays, of the smoke
script's generators: ``make_record`` (a random circular sequence, evenly
spaced genes on alternating strands, one gene across the origin) and
``count_data`` (a screen's reads: 12-nt prefix, 8-nt flanks around the
barcode, random tail, lognormal barcode abundance, a share of barcodes
outside the library and of reads with an N). Besides them: the library
drawn at PAM sites, the strain-variant mutator and the request-size deck.

Nothing here imports the program. The program's own input objects are
built from these arrays by ``portbench.workloads``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .reference.targets_ref import pam_sites, revcomp_codes

ACGT = np.frombuffer(b"ACGT", np.uint8)
# streams of one seed: each use draws from its own, so adding a draw to one
# leaves the others unchanged
STREAM = {"genome": 1, "library": 2, "deck": 3, "variant": 4, "check": 5, "reads": 6,
          "warmup": 7}


def rng(seed: int, stream: str, *more: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), STREAM[stream], *more])


@dataclass
class Gene:
    locus_tag: str
    gene: str | None
    start: int  # a gene across the origin: [start, length) + [0, end)
    end: int
    strand: int
    wraps: bool = False


@dataclass
class ContigData:
    id: str
    codes: np.ndarray  # uint8 base codes 0..3 (A C G T)
    circular: bool
    genes: list = field(default_factory=list)

    @property
    def length(self) -> int:
        return len(self.codes)

    def ascii(self) -> str:
        return ACGT[self.codes].tobytes().decode("ascii")


def make_contig(cid: str, n: int, n_genes: int, tag: str, g: np.random.Generator,
                circular: bool = True) -> ContigData:
    """The smoke script's ``make_record``: random bases, ``n_genes`` genes of
    ``max(60, n // (2 n_genes))`` bp evenly spaced on alternating strands
    (every third one named), and one gene across the origin."""
    codes = g.integers(0, 4, size=n, dtype=np.uint8)
    gene_len = max(60, n // (n_genes * 2))
    genes = []
    for i in range(n_genes):
        start = (i * n) // n_genes
        genes.append(Gene(f"{tag}_{i:04d}", f"gen{i}" if i % 3 == 0 else None, start,
                          min(start + gene_len, n), 1 if i % 2 == 0 else -1))
    genes.append(Gene(f"{tag}_WRAP", "wrp", n - 120, 80, 1, wraps=True))
    return ContigData(cid, codes, circular, genes)


def make_genome(config: dict, seed: int) -> list:
    """Every contig of a configuration, from the seed's genome stream."""
    g = rng(seed, "genome")
    return [make_contig(c["id"], c["length"], c["genes"], c["tag"], g,
                        c.get("topology", "circular") == "circular")
            for c in config["contigs"]]


def variant(contigs: list, rate: float, g: np.random.Generator) -> list:
    """A strain: ``rate`` of each contig's positions substituted by another
    base, the annotation unchanged."""
    out = []
    for c in contigs:
        codes = c.codes.copy()
        at = g.choice(c.length, int(round(rate * c.length)), replace=False)
        codes[at] = (codes[at] + g.integers(1, 4, len(at), dtype=np.uint8)) % 4
        out.append(ContigData(c.id, codes, c.circular, c.genes))
    return out


def windows(c: ContigData, pos: np.ndarray, L: int) -> np.ndarray:
    """(len(pos), L) codes of the forward windows starting at ``pos``."""
    return c.codes[(pos[:, None] + np.arange(L)) % c.length]


def sites(contigs: list, L: int, pam: str, direction: str) -> list:
    """Each contig's PAM sites: [(forward starts, reverse starts)]."""
    return [pam_sites(c.codes, c.circular, L, pam, direction) for c in contigs]


def site_library(contigs: list, per: list, L: int, size: int, site_share: float,
                 g: np.random.Generator) -> list:
    """``size`` distinct L-mers: ``site_share`` of them the spacer of a PAM
    site (``per``: the contigs' ``sites``) drawn at random over every contig
    and both strands, the rest random."""
    counts = np.array([len(f) + len(r) for f, r in per])
    seen, out = set(), []
    while len(out) < size:
        want = size - len(out)
        n_site = int(g.binomial(want, site_share))
        which = g.choice(len(contigs), n_site, p=counts / counts.sum())
        rows = [g.integers(0, 4, (want - n_site, L), dtype=np.uint8)]
        for ci, (f, r) in enumerate(per):
            k = int((which == ci).sum())
            j = g.integers(0, len(f) + len(r), k)
            fw, rv = j[j < len(f)], j[j >= len(f)] - len(f)
            rows.append(windows(contigs[ci], f[fw], L))
            rows.append(revcomp_codes(windows(contigs[ci], r[rv], L)))
        mat = np.concatenate(rows)
        mat = mat[g.permutation(len(mat))]
        for s in ACGT[mat].view(f"S{L}").ravel():
            if s not in seen:
                seen.add(s)
                out.append(s.decode("ascii"))
    return out[:size]


def size_deck(lib: dict, mismatches: list) -> list:
    """The request shapes of one deck, smallest first: library sizes at
    evenly spaced quantiles of a lognormal (median ``size_median``,
    ``size_sigma``), clipped to [size_min, size_max], each paired with a
    mismatch budget so that every budget takes an equal share. Every seed
    serves the same deck, in an order of its own (``deck_order``), so seeds
    differ in content, not in work."""
    from statistics import NormalDist

    k = lib["deck"]
    z = [NormalDist().inv_cdf((i + 0.5) / k) for i in range(k)]
    sizes = np.clip(np.round(lib["size_median"] * np.exp(lib["size_sigma"] * np.array(z))),
                    lib["size_min"], lib["size_max"]).astype(int)
    return [(int(s), int(mismatches[i % len(mismatches)])) for i, s in enumerate(sizes)]


def deck_order(k: int, strata: int, g: np.random.Generator) -> np.ndarray:
    """An order of a deck of ``k`` shapes sorted by size: the deck cut into
    ``strata`` runs of neighbouring sizes, and each round of ``strata``
    requests takes one shape from every run, in an order drawn from ``g``.
    A window that ends inside a deck has then served a balanced share of
    it, whatever the seed."""
    per = k // strata
    picks = np.stack([g.permutation(per) + s * per for s in range(strata)])  # (strata, per)
    rounds = [picks[g.permutation(strata), r] for r in range(per)]
    return np.concatenate(rounds)


@dataclass
class CountSample:
    reads: np.ndarray  # (n, read_len) uint8 ascii
    doc: dict  # barcode -> count, reads without an N
    undoc: dict  # barcode + "*" -> count
    control_doc: dict  # the same with reads whose N lies outside the barcode
    control_undoc: dict


def count_library(config: dict, seed: int, undoc_pool: int) -> tuple:
    """The screen's barcodes: the configuration's library (its
    ``library_size`` spacers at PAM sites of its genome), and a pool of
    distinct barcodes outside it."""
    contigs = make_genome(config, seed)
    L = config["spacer_len"]
    lib = site_library(contigs, sites(contigs, L, config["pam"], config["pam_direction"]), L,
                       config["library_size"], 1.0, rng(seed, "library"))
    g = rng(seed, "reads")
    known, undoc = set(lib), []
    while len(undoc) < undoc_pool:
        s = ACGT[g.integers(0, 4, L, dtype=np.uint8)].tobytes().decode("ascii")
        if s not in known:
            known.add(s)
            undoc.append(s)
    return lib, undoc


def count_sample(lib: list, undoc: list, mix: dict, g: np.random.Generator,
                 weight: np.ndarray) -> CountSample:
    """The smoke script's ``count_data`` for one single-end sample: each
    read is prefix, left flank, barcode, right flank, random tail;
    ``undocumented_share`` of them carry a pool barcode, ``n_share`` an N at
    a random position (the counter drops such reads)."""
    n, width = mix["reads"], mix["read_len"]
    L = len(lib[0])
    pre, fl, fr = (mix[k].encode() for k in ("prefix", "flank_left", "flank_right"))
    at_bc = len(pre) + len(fl)
    lib_m = np.frombuffer("".join(lib).encode(), np.uint8).reshape(-1, L)
    und_m = np.frombuffer("".join(undoc).encode(), np.uint8).reshape(-1, L)
    is_und = g.random(n) < mix["undocumented_share"]
    which = np.where(is_und, g.integers(0, len(undoc), n),
                     g.choice(len(lib), n, p=weight / weight.sum()))
    out = np.empty((n, width), np.uint8)
    for at, part in ((0, pre), (len(pre), fl), (at_bc + L, fr)):
        out[:, at:at + len(part)] = np.frombuffer(part, np.uint8)
    out[:, at_bc:at_bc + L] = np.where(is_und[:, None], und_m[np.minimum(which, len(undoc) - 1)],
                                       lib_m[np.minimum(which, len(lib) - 1)])
    tail = at_bc + L + len(fr)
    out[:, tail:] = ACGT[g.integers(0, 4, (n, width - tail), dtype=np.uint8)]
    has_n = g.random(n) < mix["n_share"]
    n_at = g.integers(0, width, int(has_n.sum()))
    out[np.nonzero(has_n)[0], n_at] = ord("N")
    n_in_bc = np.zeros(n, bool)
    n_in_bc[np.nonzero(has_n)[0]] = (n_at >= at_bc) & (n_at < at_bc + L)

    def tally(keep):
        doc = np.bincount(which[keep & ~is_und], minlength=len(lib))
        und = np.bincount(which[keep & is_und], minlength=len(undoc))
        return ({lib[i]: int(c) for i, c in enumerate(doc) if c},
                {undoc[i] + "*": int(c) for i, c in enumerate(und) if c})

    doc, und = tally(~has_n)
    cdoc, cund = tally(~n_in_bc)
    return CountSample(out, doc, und, cdoc, cund)


def write_fastq(path: str, seqs: np.ndarray) -> None:
    """The reads as FASTQ (header ``@r``, quality ``I``), written in one go."""
    n, w = seqs.shape
    rec = np.empty((n, 2 * w + 7), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + w] = seqs
    rec[:, 3 + w:6 + w] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + w:6 + 2 * w] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())
