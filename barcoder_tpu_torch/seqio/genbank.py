"""GenBank flat-file parsing and writing, from scratch (no BioPython).

Implements the subset of GenBank semantics the reference toolkit relies on
(reference: targets.py:35-165, GenBankParser.py:10-123 — both via
``Bio.SeqIO.parse(..., "genbank")``):

  - multi-record files;
  - ``record.id`` = VERSION accession (fallback LOCUS name);
  - ``record.annotations["topology"]`` from the LOCUS line (circular/linear);
  - ``record.annotations["organism"]`` from SOURCE/ORGANISM;
  - feature table with types, qualifiers (``/locus_tag``, ``/gene``, ...);
  - locations in 0-based half-open coordinates with ``complement()`` /
    ``join()`` (CompoundLocation) and partial markers ``<``/``>`` —
    origin-wrapping genes appear as ``join(N..len,1..M)`` compound locations
    (reference handles them at targets.py:102-128);
  - ORIGIN sequence.

A writer is included so tests and benchmarks can synthesize genomes
round-trippably (the reference snapshot ships no ``.gb`` files — they were
stripped as large blobs).
"""

from __future__ import annotations

import gzip
import io
import re
from dataclasses import dataclass, field


@dataclass
class Location:
    """0-based half-open interval with strand, like Bio.SeqFeature.SimpleLocation."""

    start: int
    end: int
    strand: int | None = 1  # +1 / -1 / None

    @property
    def parts(self):
        return [self]

    def __len__(self):
        return self.end - self.start


@dataclass
class CompoundLocation:
    """Multi-part location (``join(...)``), like Bio.SeqFeature.CompoundLocation."""

    parts: list[Location]

    @property
    def start(self) -> int:
        return min(p.start for p in self.parts)

    @property
    def end(self) -> int:
        return max(p.end for p in self.parts)

    @property
    def strand(self):
        strands = {p.strand for p in self.parts}
        return strands.pop() if len(strands) == 1 else None


@dataclass
class Feature:
    type: str
    location: Location | CompoundLocation
    qualifiers: dict[str, list[str]] = field(default_factory=dict)

    def qualifier(self, key: str, default=None):
        vals = self.qualifiers.get(key)
        return vals[0] if vals else default


@dataclass
class GenBankRecord:
    id: str
    name: str = ""
    description: str = ""
    seq: str = ""
    topology: str | None = None  # "circular" / "linear" / None
    organism: str | None = None
    features: list[Feature] = field(default_factory=list)

    def __len__(self):
        return len(self.seq)

    @property
    def annotations(self) -> dict:
        return {"topology": self.topology, "organism": self.organism}


_LOC_RE = re.compile(r"[<>]")


def _parse_span(text: str, strand: int) -> Location:
    text = _LOC_RE.sub("", text.strip())
    if ".." in text:
        a, b = text.split("..")
        return Location(int(a) - 1, int(b), strand)
    # single-base location "123" or site "123^124"
    if "^" in text:
        a, _ = text.split("^")
        return Location(int(a) - 1, int(a), strand)
    return Location(int(text) - 1, int(text), strand)


def parse_location(text: str) -> Location | CompoundLocation:
    """Parse a GenBank location string into a (Compound)Location.

    Handles ``a..b``, ``complement(...)``, ``join(...)``, ``order(...)``, and
    nesting of complement/join in either order; partial markers are dropped.
    """
    text = text.strip()
    strand = 1
    # peel complement wrappers (record net strand flips)
    while text.startswith("complement(") and text.endswith(")"):
        strand = -strand
        text = text[len("complement(") : -1].strip()

    m = re.match(r"^(join|order)\((.*)\)$", text, re.S)
    if m:
        inner = m.group(2)
        # split on commas not inside parens
        parts_text, depth, cur = [], 0, []
        for ch in inner:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts_text.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        parts_text.append("".join(cur))
        parts = []
        for pt in parts_text:
            sub = parse_location(pt)
            for p in sub.parts:
                p.strand *= strand
                parts.append(p)
        if strand == -1:
            # complement(join(...)): biological order is reversed
            parts = parts[::-1]
        if len(parts) == 1:
            return parts[0]
        return CompoundLocation(parts)

    return _parse_span(text, strand)


def format_location(loc: Location | CompoundLocation) -> str:
    """Inverse of parse_location (1-based inclusive GenBank syntax)."""

    def span(p: Location) -> str:
        return f"{p.start + 1}..{p.end}"

    parts = loc.parts
    if len(parts) == 1:
        s = span(parts[0])
        one = loc.strand if loc.strand is not None else parts[0].strand
        return f"complement({s})" if one == -1 else s
    if loc.strand is None and len({p.strand for p in parts}) > 1:
        # mixed-strand join (trans-spliced): per-part complement() — the
        # single-strand coercion silently flipped the minus parts to plus
        # on write (r5 review)
        inner = ",".join(
            f"complement({span(p)})" if p.strand == -1 else span(p)
            for p in parts
        )
        return f"join({inner})"
    strand = loc.strand if loc.strand is not None else 1
    inner = ",".join(span(p) for p in (parts[::-1] if strand == -1 else parts))
    joined = f"join({inner})"
    return f"complement({joined})" if strand == -1 else joined


def _open_text(path_or_handle, mode="rt"):
    if hasattr(path_or_handle, "read"):
        return path_or_handle
    # shared codec dispatch (fasta.open_seq_file): .gz AND .zst, like every
    # other text format in the package
    from .fasta import open_seq_file

    return open_seq_file(str(path_or_handle), mode)


def parse_genbank(path_or_handle) -> list[GenBankRecord]:
    """Parse all records of a GenBank flat file (plain, .gz or .zst)."""
    handle = _open_text(path_or_handle)
    close = not hasattr(path_or_handle, "read")
    try:
        return list(_iter_records(handle))
    finally:
        if close:
            handle.close()


def _iter_records(handle):
    record = None
    section = None
    feat: Feature | None = None
    loc_buf: list[str] = []
    qual_key = None
    qual_buf: list[str] = []
    seq_chunks: list[str] = []
    org_pending = False

    def flush_qualifier():
        nonlocal qual_key, qual_buf
        if feat is not None and qual_key is not None:
            val = "".join(qual_buf)
            if val.startswith('"') and val.endswith('"') and len(val) >= 2:
                val = val[1:-1]
            feat.qualifiers.setdefault(qual_key, []).append(val)
        qual_key, qual_buf = None, []

    def flush_feature():
        nonlocal feat, loc_buf
        flush_qualifier()
        if feat is not None:
            feat.location = parse_location("".join(loc_buf))
            record.features.append(feat)
        feat, loc_buf = None, []

    for raw in handle:
        line = raw.rstrip("\n")
        if record is None:
            if line.startswith("LOCUS"):
                fields = line.split()
                record = GenBankRecord(id=fields[1] if len(fields) > 1 else "", name=fields[1] if len(fields) > 1 else "")
                low = line.lower()
                if " circular" in low:
                    record.topology = "circular"
                elif " linear" in low:
                    record.topology = "linear"
            continue

        if line.startswith("//"):
            flush_feature()
            record.seq = "".join(seq_chunks).upper()
            yield record
            record, section, seq_chunks = None, None, []
            continue

        if section == "ORIGIN":
            seq_chunks.append(re.sub(r"[^A-Za-z]", "", line))
            continue

        if line[:1] not in (" ", ""):  # top-level keyword
            keyword = line[:12].strip()
            rest = line[12:].strip()
            if keyword == "DEFINITION":
                record.description = rest
                section = "DEFINITION"
            elif keyword == "VERSION":
                if rest:
                    record.id = rest.split()[0]
                section = None
            elif keyword == "SOURCE":
                section = "SOURCE"
                org_pending = False
            elif keyword == "FEATURES":
                section = "FEATURES"
            elif keyword == "ORIGIN":
                flush_feature()
                section = "ORIGIN"
            else:
                section = keyword
            continue

        # continuation lines
        if section == "DEFINITION" and line[:12].strip() == "":
            record.description += " " + line.strip()
        elif section == "SOURCE":
            stripped = line.strip()
            if stripped.startswith("ORGANISM"):
                record.organism = stripped[len("ORGANISM") :].strip()
                org_pending = True
            elif org_pending and not record.organism:
                record.organism = stripped
        elif section == "FEATURES":
            if len(line) > 5 and line[5] != " ":
                # new feature: columns 5-20 type, 21+ location
                flush_feature()
                feat = Feature(type=line[5:21].strip(), location=Location(0, 0))
                loc_buf = [line[21:].strip()]
            elif feat is not None:
                content = line[21:].strip()
                if content.startswith("/") and ("=" in content or re.fullmatch(r"/[\w-]+", content)):
                    flush_qualifier()
                    if "=" in content:
                        qual_key, val = content[1:].split("=", 1)
                        qual_buf = [val]
                    else:
                        qual_key, qual_buf = content[1:], ['""']
                elif qual_key is not None:
                    # continuation of a qualifier value; GenBank wraps on spaces
                    # except /translation which wraps mid-word
                    joiner = "" if qual_key == "translation" else " "
                    qual_buf.append(joiner + content)
                else:
                    loc_buf.append(content)

    if record is not None:  # file without trailing //
        flush_feature()
        record.seq = "".join(seq_chunks).upper()
        yield record


def write_genbank(records, path_or_handle) -> None:
    """Write records as a GenBank flat file readable by this parser (and by
    BioPython)."""
    if hasattr(path_or_handle, "write"):
        _write(records, path_or_handle)
    else:
        with open(path_or_handle, "w") as fh:
            _write(records, fh)


def _write(records, fh) -> None:
    for rec in records:
        topo = rec.topology or "linear"
        name = (rec.name or rec.id).split(".")[0]
        fh.write(
            f"LOCUS       {name:<16} {len(rec.seq)} bp    DNA     {topo:<8} BCT 01-JAN-2000\n"
        )
        fh.write(f"DEFINITION  {rec.description or rec.id}\n")
        acc = rec.id.split(".")[0]
        fh.write(f"ACCESSION   {acc}\n")
        fh.write(f"VERSION     {rec.id}\n")
        fh.write(f"SOURCE      {rec.organism or '.'}\n")
        fh.write(f"  ORGANISM  {rec.organism or '.'}\n")
        fh.write("FEATURES             Location/Qualifiers\n")
        for feat in rec.features:
            loc = format_location(feat.location)
            fh.write(f"     {feat.type:<16}{loc}\n")
            for key, vals in feat.qualifiers.items():
                for val in vals:
                    if val == "":
                        fh.write(f"                     /{key}\n")
                    else:
                        fh.write(f'                     /{key}="{val}"\n')
        fh.write("ORIGIN\n")
        seq = rec.seq.lower()
        for i in range(0, len(seq), 60):
            chunk = seq[i : i + 60]
            blocks = " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10))
            fh.write(f"{i + 1:>9} {blocks}\n")
        fh.write("//\n")


def to_genbank_string(records) -> str:
    buf = io.StringIO()
    _write(records, buf)
    return buf.getvalue()
