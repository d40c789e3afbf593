"""SnapGene ``.dna`` binary reader.

The reference bundles Zymomonas contigs only in SnapGene form
(``GCA_003054575.1/CP023716-19.dna``; the GenBank twins were stripped from
the snapshot), so first-class ``.dna`` support keeps those genomes usable.

Format (reverse-engineered, public knowledge): a stream of segments, each
``<type:1 byte><length: big-endian uint32><payload>``.  Segment types used:

  - 9:  header, payload starts with "SnapGene"
  - 0:  sequence — 1 flags byte (bit0 = circular) + ASCII sequence
  - 10: features XML (``<Features>`` with ``<Feature ... type=.. name=..>``
        containing ``<Segment range="a-b"/>`` and ``<Q name=..><V .../></Q>``)
  - 6:  notes XML

Output is a :class:`barcoder_tpu.seqio.genbank.GenBankRecord` so downstream
code is format-agnostic.
"""

from __future__ import annotations

import os
import re
import struct
import xml.etree.ElementTree as ET

from .genbank import CompoundLocation, Feature, GenBankRecord, Location


def _iter_segments(data: bytes):
    i = 0
    n = len(data)
    while i + 5 <= n:
        seg_type = data[i]
        (length,) = struct.unpack(">I", data[i + 1 : i + 5])
        payload = data[i + 5 : i + 5 + length]
        yield seg_type, payload
        i += 5 + length


def _feature_from_xml(el: ET.Element) -> Feature | None:
    ftype = el.get("type", "misc_feature")
    directionality = el.get("directionality")  # 1 fwd, 2 rev, 3 both
    strand = -1 if directionality == "2" else 1
    parts = []
    for seg in el.findall("Segment"):
        rng = seg.get("range", "")
        m = re.match(r"(\d+)-(\d+)", rng)
        if not m:
            continue
        a, b = int(m.group(1)), int(m.group(2))
        parts.append(Location(a - 1, b, strand))
    if not parts:
        return None
    loc = parts[0] if len(parts) == 1 else CompoundLocation(parts if strand == 1 else parts[::-1])
    qualifiers: dict[str, list[str]] = {}
    name = el.get("name")
    for q in el.findall("Q"):
        key = q.get("name")
        if key is None:
            continue
        for v in q.findall("V"):
            val = v.get("text") or v.get("int") or v.get("predef") or ""
            # strip SnapGene rich-text markup
            val = re.sub(r"<[^>]+>", "", val)
            qualifiers.setdefault(key, []).append(val)
    if name and "label" not in qualifiers:
        qualifiers["label"] = [name]
    if ftype == "gene" and "locus_tag" not in qualifiers and name:
        qualifiers.setdefault("locus_tag", [name])
    return Feature(type=ftype, location=loc, qualifiers=qualifiers)


def parse_snapgene(path: str) -> GenBankRecord:
    """Parse a SnapGene .dna file into a GenBankRecord. ``.dna.gz`` is
    accepted too (Genome.load advertises .gz for every format it
    dispatches; gzip is sniffed by magic, not extension)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] == b"\x1f\x8b":  # gzip magic
        import gzip

        data = gzip.decompress(data)

    base = os.path.basename(path)
    if base.endswith(".gz"):
        base = base[:-3]
    record = GenBankRecord(id=os.path.splitext(base)[0])
    record.name = record.id
    for seg_type, payload in _iter_segments(data):
        if seg_type == 0 and payload:
            flags = payload[0]
            record.topology = "circular" if flags & 0x01 else "linear"
            record.seq = payload[1:].decode("ascii", errors="replace").upper()
        elif seg_type == 10:
            try:
                root = ET.fromstring(payload.decode("utf-8", errors="replace"))
            except ET.ParseError:
                continue
            for el in root.findall(".//Feature"):
                feat = _feature_from_xml(el)
                if feat is not None:
                    record.features.append(feat)
        elif seg_type == 6:
            try:
                root = ET.fromstring(payload.decode("utf-8", errors="replace"))
            except ET.ParseError:
                continue
            title = root.findtext("Description") or root.findtext("Title")
            if title:
                record.description = title
            org = root.findtext("Organism")
            if org:
                record.organism = org
    return record


def read_snapgene_dir(path: str) -> list[GenBankRecord]:
    """Parse every .dna (or .dna.gz) file in a directory, sorted by name —
    the same extension set parse_snapgene/Genome.load accept for single
    files; a compressed contig directory previously yielded a zero-contig
    genome with no error."""
    records = []
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".dna") or fn.endswith(".dna.gz"):
            records.append(parse_snapgene(os.path.join(path, fn)))
    return records
