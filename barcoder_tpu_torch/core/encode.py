"""DNA encoding: base codes, 2-bit packing, one-hot, reverse complement.

The framework's canonical in-memory representation of sequence is an
``np.int8`` array of *base codes*: A=0, C=1, G=2, T=3, anything else
(N/ambiguity codes/gaps) = 4.  Code 4 one-hot-encodes to the zero vector, so
it never matches anything — the same effective semantics as Bowtie's
treatment of N under ``-v`` alignment (reference: targets.py:496-516 invokes
``bowtie -v N`` where N counts as a mismatch).

All functions are pure numpy; device-side variants live in ops/.
"""

from __future__ import annotations

import numpy as np

# A=0 C=1 G=2 T=3, everything else 4.
N_CODE = 4

_LUT = np.full(256, N_CODE, dtype=np.int8)
for i, b in enumerate("ACGT"):
    _LUT[ord(b)] = i
    _LUT[ord(b.lower())] = i
_LUT[ord("U")] = 3
_LUT[ord("u")] = 3

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement: A<->T, C<->G, N->N
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)

_COMP_ASCII = np.arange(256, dtype=np.uint8)
for a, b in zip(b"ACGTacgtNn", b"TGCAtgcaNn"):
    _COMP_ASCII[a] = b


# public aliases for vectorized ascii-level transforms
DECODE_ASCII = _DECODE
COMP_ASCII = _COMP_ASCII


def encode(seq: str | bytes | bytearray) -> np.ndarray:
    """Encode a DNA string to an int8 code array (A0 C1 G2 T3, other 4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _LUT[np.frombuffer(bytes(seq), dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """Decode an int8 code array back to an uppercase DNA string."""
    return _DECODE[np.asarray(codes, dtype=np.int8).clip(0, 4)].tobytes().decode("ascii")


def complement_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.int8)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array."""
    return _COMP[np.asarray(codes, dtype=np.int8)][::-1].copy()


def revcomp(seq: str) -> str:
    """Reverse complement of a DNA string, preserving case and mapping any
    non-ACGT letter to N-like passthrough via ASCII complement table.

    Matches the reference's ``rev_comp`` (heuristicount.py:29-30) for
    ATCGN input and additionally handles lowercase.
    """
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMP_ASCII[arr][::-1].tobytes().decode("ascii")


def onehot(codes: np.ndarray, dtype=np.float32) -> np.ndarray:
    """One-hot encode codes to shape (..., 4). Code 4 (N) maps to all-zero."""
    codes = np.asarray(codes, dtype=np.int8)
    out = np.zeros(codes.shape + (4,), dtype=dtype)
    for b in range(4):
        out[..., b] = codes == b
    return out


def pack_2bit(codes: np.ndarray, word_dtype=np.uint32) -> np.ndarray:
    """Pack base codes into 2-bit lanes of an unsigned integer word array.

    N (code 4) is packed as 0 (A); callers that need exact N semantics must
    carry a separate N mask — the scan kernels use one-hot encoding instead,
    where N is naturally non-matching.
    """
    codes = np.asarray(codes, dtype=np.int64) & 3
    bits_per = np.dtype(word_dtype).itemsize * 8
    lanes = bits_per // 2
    n = len(codes)
    n_words = -(-n // lanes)
    padded = np.zeros(n_words * lanes, dtype=np.int64)
    padded[:n] = codes
    padded = padded.reshape(n_words, lanes)
    shifts = (2 * np.arange(lanes, dtype=np.int64))[None, :]
    return (padded << shifts).sum(axis=1).astype(word_dtype)


def gc_content(seq: str) -> float:
    """Fraction of G+C characters (reference: mismatch.py:10-12)."""
    if not seq:
        return 0.0
    return (seq.count("G") + seq.count("C")) / len(seq)
