"""Slab-based FASTQ/.reads readers producing byte matrices.

The reference feeds its counting pool with per-line Python string lists
(heuristicount.py:100-153); at millions of reads the Python loop is the
bottleneck. Here files are read as large byte slabs, cut at record
boundaries with one vectorized newline scan, and parsed into fixed-width
uint8 matrices by the native seqpack library (numpy fallback built in) —
the representation the vectorized counting engine consumes directly.
"""

from __future__ import annotations

import numpy as np

from .. import native_bridge
from .fasta import detect_reads_format, open_seq_file

_SLAB = 8 << 20  # bytes per read() call


class MatrixStream:
    """Stream of (matrix uint8 (n, width), lengths int64) record batches.

    Newline positions are found ONCE per byte (a vectorized scan of each
    freshly-read slab, kept in an incrementally-consumed index array).
    The previous design re-ran ``np.nonzero`` over the whole remaining
    buffer on every cut, scanning each byte 2-3x — a top-3 cost of the
    1M-read counting pipeline and ~2/3 of the multi-host skip path (r5)."""

    def __init__(self, path: str):
        self.fmt = detect_reads_format(path)  # 'fastq' or 'reads'
        self.lines_per_record = 4 if self.fmt == "fastq" else 1
        self.fh = open_seq_file(path, "rb")
        self.buf = b""
        self._off = 0  # consumed bytes of buf (cuts advance the offset;
        # slicing the multi-MB tail off on every cut memmoved ~15x the
        # stream size at the 2^14-record chunk geometry, r5 review)
        self.eof = False
        # ABSOLUTE newline offsets into buf; consumed entries advance
        # _nl_start in lockstep with _off
        self._nl_pos = np.zeros(0, np.int64)
        self._nl_start = 0

    def close(self):
        self.fh.close()

    def _avail(self) -> int:
        return len(self._nl_pos) - self._nl_start

    def _compact(self) -> None:
        """Drop the consumed prefix — called once per fill, so each byte
        is copied O(1) times regardless of the cut geometry."""
        if self._off:
            self.buf = self.buf[self._off :]
            self._nl_pos = self._nl_pos[self._nl_start :] - self._off
            self._off = 0
            self._nl_start = 0
        elif self._nl_start:
            self._nl_pos = self._nl_pos[self._nl_start :]
            self._nl_start = 0

    def _fill_lines(self, want_lines: int) -> None:
        need_newlines = want_lines + 1
        if self.eof or self._avail() >= need_newlines:
            return
        self._compact()
        parts = [self.buf]
        new_pos = [self._nl_pos]
        avail = len(self._nl_pos)
        end = len(self.buf)
        while not self.eof and avail < need_newlines:
            blob = self.fh.read(_SLAB)
            if not blob:
                self.eof = True
                break
            arr = np.frombuffer(blob, dtype=np.uint8)
            p = np.nonzero(arr == 10)[0] + end  # the ONE scan of these bytes
            new_pos.append(p)
            avail += len(p)
            parts.append(blob)
            end += len(blob)
        if len(parts) > 1:
            self.buf = b"".join(parts)
        self._nl_pos = (
            new_pos[0] if len(new_pos) == 1 else np.concatenate(new_pos)
        )

    def next_records(self, n: int):
        """Up to n records as (matrix, lengths); None at end of stream."""
        chunk_take = self._cut_records(n)
        if chunk_take is None:
            return None
        chunk, take, cnl = chunk_take

        # row width = longest sequence line in the chunk (line boundaries
        # come from the cached newline index — no rescan)
        starts = np.concatenate(([0], cnl + 1))
        ends = np.concatenate((cnl, [len(chunk)]))
        line_lens = ends - starts[: len(ends)]
        if self.fmt == "fastq":
            seq_lens = line_lens[1::4]
        else:
            seq_lens = line_lens
        width = int(seq_lens.max()) if len(seq_lens) else 1
        width = max(width, 1)
        if self.fmt == "fastq":
            mat, lens = native_bridge.parse_fastq_buffer(chunk, width, take)
        else:
            mat, lens = native_bridge.parse_reads_buffer(chunk, width, take)
        return mat, lens

    def skip_records(self, n: int):
        """Consume up to n records WITHOUT parsing them into a matrix;
        returns the record count (None at end of stream). The multi-host
        chunk-ownership reader uses this so a host scans (one memchr-speed
        newline pass) the chunks it does not own instead of paying the
        full matrix parse for rows it would discard. The count matches
        what ``next_records`` would have returned for the SAME chunk —
        the lockstep invariant multi-host scheduling is built on (blank
        ``.reads`` lines are not records; a truncated final FASTQ record
        is)."""
        chunk_take = self._cut_records(n, count_only=True)
        if chunk_take is None:
            return None
        return chunk_take[1]

    def _line_spans(self, upto_lines: int, cut_end: int):
        """ABSOLUTE (starts, ends) of the next ``upto_lines``
        newline-terminated lines plus the unterminated tail line when
        ``cut_end`` runs past the last newline."""
        cnl = self._nl_pos[self._nl_start : self._nl_start + upto_lines]
        starts = np.concatenate(([self._off], cnl + 1))
        ends = np.concatenate((cnl, [cut_end]))
        if len(starts) and starts[-1] >= cut_end:
            starts, ends = starts[:-1], ends[:-1]
        return starts, ends

    def _nonblank_mask(self, starts, ends) -> np.ndarray:
        """Which lines are records for the ``.reads`` parsers: non-empty
        after CR-strip (native/sp_parse_reads semantics)."""
        lens = ends - starts
        arr = np.frombuffer(self.buf, dtype=np.uint8)  # zero-copy view
        idx = np.clip(starts, 0, max(len(arr) - 1, 0))
        cr_only = (lens == 1) & (arr[idx] == 13)
        return (lens > 0) & ~cr_only

    def _cut_records(self, n: int, count_only: bool = False):
        """Consume up to n records; returns (raw chunk bytes, record
        count, chunk-relative newline offsets) or None at end of stream.
        n <= 0 returns an EMPTY batch (b'', 0, []) without consuming —
        None stays unambiguous as the end-of-stream sentinel. With
        count_only=True the chunk/offsets are not materialized
        (None, count, None).

        Record semantics match the parsers and the reference's readline
        loop: for ``.reads``, records are the NONBLANK lines (cuts consume
        however many lines hold n of them, so paired streams stay aligned
        by RECORD even when one file carries blank lines); trailing blank
        lines are not records; a truncated final FASTQ record (missing
        +/quality lines) IS one. Blank lines in the MIDDLE of a FASTQ
        file are out of scope (no FASTQ writer emits them; the 4-line
        structural model cuts on line counts)."""
        if n <= 0:
            return b"", 0, np.zeros(0, np.int64)
        lpr = self.lines_per_record
        if self.fmt == "fastq":
            self._fill_lines(n * lpr)
        else:
            # blanks don't count toward n: keep filling until n nonblank
            # lines are visible (or the stream ends)
            want = n
            while True:
                self._fill_lines(want)
                if self.eof:
                    break
                avail = self._avail()
                last = int(self._nl_pos[-1]) + 1 if avail else self._off
                nb = self._nonblank_mask(*self._line_spans(avail, last))
                if int(nb.sum()) >= n:
                    break
                want *= 2
        if self._off >= len(self.buf):
            return None
        avail = self._avail()
        buf_end = len(self.buf)
        last_nl_end = int(self._nl_pos[-1]) + 1 if avail else self._off
        if self.eof:
            total_lines = avail + (1 if buf_end > last_nl_end else 0)
            # trim trailing blank lines (a final "\n" or "\r\n" run)
            starts, ends = self._line_spans(avail, buf_end)
            arr = np.frombuffer(self.buf, dtype=np.uint8)
            while total_lines:
                s, e = int(starts[total_lines - 1]), int(ends[total_lines - 1])
                if e > s and not (e - s == 1 and arr[s] == 13):
                    break
                total_lines -= 1
            scope_end = buf_end
        else:
            total_lines = avail
            starts, ends = self._line_spans(avail, last_nl_end)
            scope_end = last_nl_end
        starts, ends = starts[:total_lines], ends[:total_lines]
        if self.fmt == "fastq":
            # ceil: a truncated final record still counts (reference
            # readline semantics; the native FASTQ parser keeps it too)
            n_records = (
                -(-total_lines // lpr) if self.eof else total_lines // lpr
            )
        else:
            nb = self._nonblank_mask(starts, ends)
            n_records = int(nb.sum())
        take = min(n, n_records)
        if take == 0:
            if self.eof:
                self._off = len(self.buf)
                self._nl_start = len(self._nl_pos)
                return None
            return None
        if self.fmt == "fastq":
            if self.eof and take == n_records:
                cut = buf_end
                consumed_nl = avail
            else:
                cut = int(self._nl_pos[self._nl_start + take * lpr - 1]) + 1
                consumed_nl = take * lpr
        else:
            # line index holding the take-th nonblank record
            li = int(np.searchsorted(np.cumsum(nb), take))
            if li < avail:  # newline-terminated line
                cut = int(self._nl_pos[self._nl_start + li]) + 1
                consumed_nl = li + 1
            else:  # the unterminated eof tail line
                cut = buf_end
                consumed_nl = avail
        if count_only:
            chunk, cnl = None, None
        else:
            cnl = (
                self._nl_pos[self._nl_start : self._nl_start + consumed_nl]
                - self._off
            )
            chunk = self.buf[self._off : cut]
        self._nl_start += consumed_nl
        self._off = cut
        if self.eof and self._off >= len(self.buf):
            # release the final slab
            self.buf = b""
            self._off = 0
            self._nl_pos = np.zeros(0, np.int64)
            self._nl_start = 0
        return chunk, take, cnl


def iter_owned_matrix_chunks(
    file1: str,
    file2: str | None = None,
    chunk_size: int = 2**16,
    owner: int = 0,
    num_owners: int = 1,
    start_chunk: int = 0,
):
    """Chunk-ownership reader for multi-host counting: yields
    ``(chunk_idx, n_records, r1, r2)`` for EVERY chunk of the stream, but
    parses matrices only for chunks this process owns
    (``chunk_idx % num_owners == owner``); unowned chunks (and chunks below
    ``start_chunk`` — the checkpoint-resume skip) yield
    ``(chunk_idx, n, None, None)`` after a cheap byte-level skip.

    Every process scans the same files with the same geometry, so all
    processes observe the identical ``(chunk_idx, n_records)`` stream —
    the shared knowledge the lockstep sharded-counting dispatch schedule
    is derived from. This is the multi-host generalization of the
    reference's fork pool DIVIDING parse work across workers
    (heuristicount.py:720-722) instead of replicating it: N hosts each
    pay 1/N of the matrix-parse cost.
    """
    s1 = MatrixStream(file1)
    s2 = None
    try:
        s2 = MatrixStream(file2) if file2 else None
        chunk_idx = 0
        while True:
            mine = chunk_idx >= start_chunk and chunk_idx % num_owners == owner
            if mine:
                r1 = s1.next_records(chunk_size)
                if r1 is None:
                    break
                n1 = len(r1[1])
            else:
                n1 = s1.skip_records(chunk_size)
                if n1 is None:
                    break
                r1 = None
            r2 = None
            if s2 is not None:
                if mine:
                    r2 = s2.next_records(n1)
                    n2 = None if r2 is None else len(r2[1])
                else:
                    n2 = s2.skip_records(n1)
                if n2 != n1:
                    raise ValueError(
                        "Length of reads1 and reads2 must be the same for paired-end data."
                    )
            yield chunk_idx, n1, r1, r2
            chunk_idx += 1
    finally:
        s1.close()
        if s2:
            s2.close()


def iter_matrix_chunks(file1: str, file2: str | None = None, chunk_size: int = 2**16):
    """Yield ((mat1, lens1), (mat2, lens2) | None) batches of co-indexed
    records; the final batch may be short.

    Delegates to the ownership iterator with a single owner so the chunk
    schedule has exactly ONE definition — multi-host byte-identical output
    depends on the single- and multi-process paths never cutting chunks
    differently."""
    for _idx, _n, r1, r2 in iter_owned_matrix_chunks(
        file1, file2, chunk_size, owner=0, num_owners=1
    ):
        yield r1, r2
