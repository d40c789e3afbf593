"""FASTA / FASTQ / raw-reads IO with gzip and zstd transport.

Covers the reference's scattered readers/writers:
  - FASTA read/write (reference: targets.py:35-56, BowtieRunner.py:55-63)
  - fake-quality FASTQ bridge (reference: targets.py:59-73 — only needed
    there because Bowtie wants FASTQ; kept here for format parity)
  - barcode FASTA reader that takes bare sequence lines
    (reference: heuristicount.py:41-57)
  - chunked FASTQ/.reads readers (reference: heuristicount.py:100-153)
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - zstd is present in the target env
    _zstd = None


def open_seq_file(path: str, mode: str = "rt"):
    """Open a possibly-compressed text file (.gz / .zst / plain)."""
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    if path.endswith(".zst"):
        if _zstd is None:
            raise RuntimeError("zstandard module unavailable; cannot read .zst")
        return _zstd.open(path, mode)
    return open(path, mode)


def strip_compression_ext(path: str) -> str:
    if path.endswith(".gz") or path.endswith(".zst"):
        return os.path.splitext(path)[0]
    return path


def iter_fasta(path_or_handle) -> Iterator[tuple[str, str, str]]:
    """Yield (id, description, sequence) from a FASTA file."""
    handle = path_or_handle if hasattr(path_or_handle, "read") else open_seq_file(path_or_handle)
    close = not hasattr(path_or_handle, "read")
    try:
        header, chunks = None, []
        for line in handle:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None:
                    hid = header.split()[0] if header else ""
                    yield hid, header, "".join(chunks)
                header, chunks = line[1:], []
            elif line:
                chunks.append(line.strip())
        if header is not None:
            hid = header.split()[0] if header else ""
            yield hid, header, "".join(chunks)
    finally:
        if close:
            handle.close()


def read_fasta(path_or_handle) -> list[tuple[str, str, str]]:
    return list(iter_fasta(path_or_handle))


def write_fasta(records, path_or_handle, width: int = 70) -> None:
    """Write (id, seq) or (id, description, seq) tuples as FASTA."""

    def _write(fh):
        for rec in records:
            if len(rec) == 3:
                rid, desc, seq = rec
                words = desc.split() if desc else []
                # whitespace-only descriptions count as absent (split()[0]
                # on them raised IndexError)
                header = (
                    desc if words and words[0] == rid
                    else (f"{rid} {desc}".strip() if words else rid)
                )
            else:
                rid, seq = rec
                header = rid
            fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")

    if hasattr(path_or_handle, "write"):
        _write(path_or_handle)
    else:
        with open(path_or_handle, "w") as fh:
            _write(fh)


def read_barcode_fasta(path: str) -> set[str]:
    """Barcode FASTA reader: every non-header line is a barcode
    (reference: heuristicount.py:41-57 — note it adds *lines*, not records,
    so multi-line FASTA records become multiple barcodes; we reproduce that
    contract, including the accepted extensions)."""
    if not (
        path.endswith(".gz")
        or path.endswith(".zst")
        or path.endswith(".fasta")
        or path.endswith(".fa")
    ):
        raise ValueError(
            f'"{path}" does not appear to be a supported fasta file: .fasta or .fa.'
        )
    barcodes = set()
    with open_seq_file(path) as fh:
        for line in fh:
            if not line.startswith(">"):
                stripped = line.strip()
                if stripped:
                    barcodes.add(stripped)
    return barcodes


def iter_fastq(path_or_handle) -> Iterator[tuple[str, str, str]]:
    """Yield (name, sequence, quality) from FASTQ."""
    handle = path_or_handle if hasattr(path_or_handle, "read") else open_seq_file(path_or_handle)
    close = not hasattr(path_or_handle, "read")
    try:
        while True:
            header = handle.readline()
            if not header:
                break
            # .strip(), not rstrip("\n"): CRLF files otherwise leave \r on
            # every field (iter_fasta/iter_read_chunks already strip)
            seq = handle.readline().strip()
            handle.readline()  # '+'
            qual = handle.readline().strip()
            yield header.strip()[1:], seq, qual
    finally:
        if close:
            handle.close()


def write_fastq(records, path_or_handle, quality: int | None = None) -> None:
    """Write (name, seq[, qual]) records as FASTQ; with ``quality`` set, a
    uniform fake quality is applied (reference: targets.py:59-73 writes Q40
    so Bowtie accepts FASTA guides — Q40 is ASCII 'I')."""

    def _write(fh):
        for rec in records:
            if quality is not None or len(rec) == 2:
                name, seq = rec[0], rec[1]
                q = chr(33 + (quality if quality is not None else 40)) * len(seq)
            else:
                name, seq, q = rec
            fh.write(f"@{name}\n{seq}\n+\n{q}\n")

    if hasattr(path_or_handle, "write"):
        _write(path_or_handle)
    else:
        with open(path_or_handle, "w") as fh:
            _write(fh)


def detect_reads_format(path: str) -> str:
    """'fastq' or 'reads' based on extension after stripping compression
    (reference: heuristicount.py:106-116)."""
    stripped = strip_compression_ext(path)
    if stripped.endswith(".fastq") or stripped.endswith(".fq"):
        return "fastq"
    if stripped.endswith(".reads"):
        return "reads"
    raise ValueError("Unsupported file type. Must be '.fastq' or '.reads'.")


def iter_read_chunks(
    file1: str, file2: str | None = None, chunk_size: int = 2**16
) -> Iterator[tuple[list[str], list[str] | None]]:
    """Stream sequence-only chunks from FASTQ or .reads files, optionally
    zipped with a mate file (reference: heuristicount.py:100-153).

    Yields (reads1, reads2-or-None); final chunk may be short.
    """
    fmt = detect_reads_format(file1)
    f1 = open_seq_file(file1)
    f2 = open_seq_file(file2) if file2 else None
    try:
        reads1: list[str] = []
        reads2: list[str] = []
        while True:
            if fmt == "fastq":
                header = f1.readline()
                if not header:
                    break
                if f2:
                    h2 = f2.readline()
                    if not h2:
                        # mate-file EOF stops BOTH streams, like the
                        # reference's zipped chunk readers hitting
                        # StopIteration (heuristicount.py:100-153) —
                        # padding with '' silently diluted pairing stats
                        break
                reads1.append(f1.readline().strip())
                f1.readline()
                f1.readline()
                if f2:
                    reads2.append(f2.readline().strip())
                    f2.readline()
                    f2.readline()
            else:
                line = f1.readline()
                if not line:
                    break
                if f2:
                    l2 = f2.readline()
                    if not l2:
                        break  # mate EOF: stop both streams (see above)
                    reads2.append(l2.strip())
                reads1.append(line.strip())
            if len(reads1) >= chunk_size:
                yield reads1, (reads2 if f2 else None)
                reads1, reads2 = [], []
        if reads1:
            yield reads1, (reads2 if f2 else None)
    finally:
        f1.close()
        if f2:
            f2.close()
