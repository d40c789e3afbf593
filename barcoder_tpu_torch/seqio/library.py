"""Barcode / spacer library loading.

Mirrors the reference's BarCodeLibrary (BarCodeLibrary.py:9-102): load from
FASTA or TSV-with-named-column, set semantics, add/remove/size — plus the
name↔sequence mapping the monolithic pipeline needs (targets.py keys output
on the FASTA record *name*; duplicate sequences under different names feed
the per-spacer ``count`` column, targets.py:632-634).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

from .fasta import iter_fasta, open_seq_file


class BarcodeLibraryError(Exception):
    """Raised for library loading errors (reference: BarCodeLibrary.py:96-102)."""


@dataclass
class BarcodeLibrary:
    """A set of barcode/spacer sequences with their source names.

    ``entries`` preserves one (name, sequence) pair per input record;
    ``barcodes`` is the deduplicated sequence set.
    """

    entries: list[tuple[str, str]] = field(default_factory=list)

    @property
    def barcodes(self) -> set[str]:
        return {seq for _, seq in self.entries}

    @property
    def size(self) -> int:
        return len(self.barcodes)

    def add(self, sequence: str, name: str | None = None) -> None:
        self.entries.append((name if name is not None else sequence, sequence))

    def remove(self, sequence: str) -> None:
        self.entries = [(n, s) for n, s in self.entries if s != sequence]

    @classmethod
    def from_fasta(cls, path: str) -> "BarcodeLibrary":
        lib = cls()
        for rid, _, seq in iter_fasta(path):
            lib.add(seq.upper(), rid)
        if not lib.entries:
            raise BarcodeLibraryError(f"No sequences found in {path}")
        return lib

    @classmethod
    def from_tsv(cls, path: str, column: str) -> "BarcodeLibrary":
        if column is None:
            raise BarcodeLibraryError("A barcode column must be specified for TSV files")
        lib = cls()
        with open_seq_file(path) as fh:
            reader = csv.reader(fh, delimiter="\t")
            header = next(reader)
            if column not in header:
                raise BarcodeLibraryError(f"Column '{column}' not found in file")
            idx = header.index(column)
            for row in reader:
                if len(row) > idx and row[idx]:
                    lib.add(row[idx].upper())
        if not lib.entries:
            raise BarcodeLibraryError(f"No sequences found in {path}")
        return lib

    @classmethod
    def from_list(cls, barcodes) -> "BarcodeLibrary":
        lib = cls()
        for seq in barcodes:
            lib.add(seq.upper())
        return lib

    @classmethod
    def from_unique_list(cls, barcodes: list[str]) -> "BarcodeLibrary":
        """Identity-named library from ALREADY-UNIQUE, already-normalized
        sequences (the design workload's candidate list). The flag lets
        run_targets skip its per-entry name/dedup bookkeeping — ~1.5 s of
        dict building at 573k candidates."""
        lib = cls(entries=[(s, s) for s in barcodes])
        lib.identity_unique = True
        return lib

    @classmethod
    def load(cls, path: str, column: str | None = None) -> "BarcodeLibrary":
        """Dispatch on extension like the reference reader
        (BarCodeLibrary.py:19-25); fastq inputs take the read sequences."""
        base = os.path.basename(path)
        # dispatch on the UNCOMPRESSED name: .fq.gz/.fa.zst etc. are as
        # readable as their plain forms (open_seq_file handles both codecs)
        if base.endswith(".gz") or base.endswith(".zst"):
            base = os.path.splitext(base)[0]
        if ".fasta" in base or base.endswith(".fa"):
            return cls.from_fasta(path)
        if ".tsv" in base:
            return cls.from_tsv(path, column or "spacer")
        if ".fastq" in base or base.endswith(".fq"):
            from .fasta import iter_fastq

            lib = cls()
            for name, seq, _ in iter_fastq(path):
                lib.add(seq.upper(), name.split()[0] if name else seq)
            return lib
        raise BarcodeLibraryError(f"Unsupported file format: {path}")

    def lengths(self) -> set[int]:
        return {len(s) for s in self.barcodes}
