"""ctypes bridge to the native seqpack library (native/seqpack.cpp).

Compiles the shared library on first use with g++ (cached under
``build/``); every entry point has a numpy fallback so the framework is
fully functional without a toolchain. Use ``seqpack_available()`` to check
which path is active; set BARCODER_TPU_NO_NATIVE=1 to force the fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "seqpack.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libseqpack.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a unique temp and publish atomically: concurrent
    # processes (the multi-host harness spawns N at once) racing g++ into
    # one path could CDLL a half-written .so and silently downgrade that
    # host to the numpy fallback (r5 review)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def get_lib():
    """The loaded ctypes library, or None when native is unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("BARCODER_TPU_NO_NATIVE"):
            return None
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        ll = ctypes.c_longlong
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        llp = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.sp_parse_fastq.restype = ll
        lib.sp_parse_fastq.argtypes = [ctypes.c_char_p, ll, u8p, llp, ll, ll]
        lib.sp_parse_reads.restype = ll
        lib.sp_parse_reads.argtypes = [ctypes.c_char_p, ll, u8p, llp, ll, ll]
        lib.sp_encode_codes.restype = None
        lib.sp_encode_codes.argtypes = [u8p, i8p, ll]
        lib.sp_revcomp_ascii.restype = None
        lib.sp_revcomp_ascii.argtypes = [u8p, u8p, ll, ll]
        lib.sp_pack_2bit64.restype = None
        lib.sp_pack_2bit64.argtypes = [u8p, u64p, ll, ll]
        lib.sp_count_exact.restype = ll
        lib.sp_count_exact.argtypes = [
            u8p, llp, ll, ll, ll,
            ctypes.c_char_p, ll, ctypes.c_char_p, ll, ll,
            u64p, ll, llp, llp, ll,
        ]
        lib.sp_count_exact_mt.restype = ll
        lib.sp_count_exact_mt.argtypes = lib.sp_count_exact.argtypes + [ll]
        _lib = lib
        return _lib


def seqpack_available() -> bool:
    return get_lib() is not None


def parse_fastq_buffer(data: bytes, row_width: int, max_reads: int | None = None):
    """FASTQ text → (matrix uint8 (n, row_width) 0-padded, lengths int64).

    Native single pass when available; numpy/python fallback otherwise.
    """
    lib = get_lib()
    if max_reads is None:
        max_reads = data.count(b"\n") // 4 + 1
    if lib is not None:
        out = np.zeros((max_reads, row_width), dtype=np.uint8)
        lengths = np.zeros(max_reads, dtype=np.int64)
        n = lib.sp_parse_fastq(data, len(data), out, lengths, max_reads, row_width)
        if n >= 0:
            return out[:n], lengths[:n]
    # fallback — must COUNT records exactly like sp_parse_fastq and
    # MatrixStream's cut arithmetic (empty sequence lines and a
    # header-only truncated final record are records; blank lines between
    # records are tolerated): a count mismatch desyncs the multi-host
    # lockstep dispatch schedule (r5 review)
    seqs = []
    lines = data.split(b"\n")
    li = 0
    while li < len(lines):
        if lines[li] in (b"", b"\r"):
            li += 1
            continue
        seq = lines[li + 1] if li + 1 < len(lines) else b""
        seqs.append(seq.rstrip(b"\r"))
        li += 4
    n = min(len(seqs), max_reads)
    out = np.zeros((n, row_width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int64)
    for i in range(n):
        s = seqs[i]
        lengths[i] = len(s)
        row = np.frombuffer(s[:row_width], dtype=np.uint8)
        out[i, : len(row)] = row
    return out, lengths


def parse_reads_buffer(data: bytes, row_width: int, max_reads: int | None = None):
    """.reads text (one sequence/line) → (matrix, lengths)."""
    lib = get_lib()
    if max_reads is None:
        max_reads = data.count(b"\n") + 1
    if lib is not None:
        out = np.zeros((max_reads, row_width), dtype=np.uint8)
        lengths = np.zeros(max_reads, dtype=np.int64)
        n = lib.sp_parse_reads(data, len(data), out, lengths, max_reads, row_width)
        if n >= 0:
            return out[:n], lengths[:n]
    # records = non-empty after CR strip, exactly like sp_parse_reads and
    # MatrixStream._nonblank_mask (s.strip() dropped whitespace-only lines
    # the native parser keeps — a lockstep count divergence, r5 review)
    seqs = [
        t for s in data.split(b"\n") if (t := s.rstrip(b"\r")) != b""
    ]
    n = min(len(seqs), max_reads)
    out = np.zeros((n, row_width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int64)
    for i in range(n):
        s = seqs[i]
        lengths[i] = len(s)
        row = np.frombuffer(s[:row_width], dtype=np.uint8)
        out[i, : len(row)] = row
    return out, lengths


def encode_codes(ascii_arr: np.ndarray) -> np.ndarray:
    """uint8 ASCII array → int8 base codes (shape-preserving)."""
    lib = get_lib()
    flat = np.ascontiguousarray(ascii_arr, dtype=np.uint8).reshape(-1)
    if lib is not None:
        out = np.empty(flat.shape, dtype=np.int8)
        lib.sp_encode_codes(flat, out, len(flat))
        return out.reshape(ascii_arr.shape)
    from .core.encode import _LUT

    return _LUT[flat].reshape(ascii_arr.shape)


def revcomp_ascii(mat: np.ndarray) -> np.ndarray:
    """(rows, width) uint8 ASCII → case-preserving reverse complement."""
    lib = get_lib()
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if lib is not None:
        out = np.empty_like(mat)
        lib.sp_revcomp_ascii(mat, out, mat.shape[0], mat.shape[1])
        return out
    from .core.encode import COMP_ASCII

    return COMP_ASCII[mat][:, ::-1].copy()


def pack_2bit64(ascii_mat: np.ndarray) -> np.ndarray:
    """(rows, w<=32) uint8 ASCII → uint64 keys; non-ACGT rows poisoned."""
    lib = get_lib()
    mat = np.ascontiguousarray(ascii_mat, dtype=np.uint8)
    rows, w = mat.shape
    assert w <= 32
    if lib is not None:
        keys = np.empty(rows, dtype=np.uint64)
        lib.sp_pack_2bit64(mat, keys, rows, w)
        return keys
    from .core.encode import _LUT

    codes = _LUT[mat]
    bad = (codes >= 4).any(axis=1)
    vals = codes.astype(np.uint64) & np.uint64(3)
    keys = np.zeros(rows, dtype=np.uint64)
    for j in range(w):
        keys |= vals[:, j] << np.uint64(2 * j)
    keys[bad] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return keys


def count_exact(
    reads_mat: np.ndarray,
    lengths: np.ndarray,
    start: int,
    l_flank: str,
    r_flank: str,
    bc_len: int,
    bc_keys_sorted: np.ndarray,
    max_undoc: int = 1 << 20,
    n_threads: int | None = None,
):
    """Native single-end exact counting; returns (doc_counts int64 aligned
    with bc_keys_sorted, undoc_row_indices). None if native unavailable.

    n_threads defaults to the reference's worker policy, cpu_count() // 2
    (heuristicount.py:720-722), capped at 16; results are deterministic
    and identical to the single-thread loop."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(max((os.cpu_count() or 2) // 2, 1), 16)
    reads_mat = np.ascontiguousarray(reads_mat, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    bc_keys_sorted = np.ascontiguousarray(bc_keys_sorted, dtype=np.uint64)
    # a chunk can yield at most one undoc row per read: clamping avoids
    # zeroing an 8 MB buffer per ~64K-read call (r5 review)
    max_undoc = min(max_undoc, reads_mat.shape[0])
    doc = np.zeros(len(bc_keys_sorted), dtype=np.int64)
    undoc = np.zeros(max_undoc, dtype=np.int64)
    n_undoc = lib.sp_count_exact_mt(
        reads_mat, lengths, reads_mat.shape[0], reads_mat.shape[1],
        start, l_flank.encode(), len(l_flank), r_flank.encode(), len(r_flank),
        bc_len, bc_keys_sorted, len(bc_keys_sorted), doc, undoc, max_undoc,
        n_threads,
    )
    return doc, undoc[:n_undoc]
