"""Every read's counting test in one pass over the raw read matrix, for
``pipeline.heuristic_count.CudaCounter``.

:func:`count_match` takes a batch of reads as the reader yields them (a
``uint8`` matrix, zero-padded past each read's end; paired input has both
mates') and does the whole per-read contract of
``VectorCounter.process_matrices`` with ``CudaCounter``'s exact match: a
row whose window runs past the read's end is truncated (left to the host's
per-read oracle), a row with an uppercase N (either mate) is dropped, the
flanks are compared, the core is packed into ``_pack_codes``' 64-bit key
(reverse complemented for a reverse read; a pair is consistent when the
two keys are equal), a pure-ACGT core is looked up in the library's keys
sorted as int64 and a hit adds one to the shard's accumulator. It returns
two lists of row indices: the eligible rows that did not hit, whose cores
the host tallies as undocumented, and the truncated rows.

A CUDA tensor launches ``csrc/count_match.cu`` (one thread a read, the
block's rows staged in shared memory; built by ``nvcc.py``), a CPU tensor
takes :func:`count_match_reference`, the plain torch version with the same
contract. Nothing falls back: a kernel that does not build or launch
raises. The JAX package had no kernel here: its ``DeviceCounter`` matched
with ``jnp.dot`` outside Pallas and tested each read in host numpy.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import nvcc

# kernel launches since the counter was last reset (the smoke run resets it
# and checks one launch per dispatched batch and shard); :func:`load`'s
# empty launch is not counted
launches = 0


@dataclass(frozen=True)
class MatchTable:
    """What the test of every batch shares, on one device: the library's
    keys sorted as int64 and each key's row of the counts; the flanks (L1
    R1 L2 R2 back to back in ``flanks``, their lengths in ``lens``); each
    mate's window start and the barcode length."""

    keys: torch.Tensor
    rows: torch.Tensor
    flanks: torch.Tensor
    lens: tuple
    starts: tuple
    bc_len: int

    def to(self, device) -> "MatchTable":
        return MatchTable(self.keys.to(device), self.rows.to(device), self.flanks.to(device),
                          self.lens, self.starts, self.bc_len)


def match_table(keys, rows, *, bc_len, L1=None, R1=None, L2=None, R2=None, start1=None,
                start2=None) -> MatchTable:
    """The table of a counting config: ``keys`` (int64, sorted ascending)
    and ``rows`` on their device; a flank of None is empty, a start of None
    is 0, as ``VectorCounter`` reads them."""
    parts = [(f or "").encode() for f in (L1, R1, L2, R2)]
    flanks = torch.frombuffer(bytearray(b"".join(parts) or b"\0"), dtype=torch.uint8)
    return MatchTable(keys, rows, flanks.to(keys.device), tuple(len(p) for p in parts),
                      (start1 or 0, start2 or 0), int(bc_len))


def _check(table: MatchTable, m1, m2, acc):
    mats = [m for m in (m1, m2) if m is not None]
    if not mats:
        raise ValueError("count_match needs m1, m2 or both")
    dev = mats[0].device
    for name, x, dtype in (("m1", m1, torch.uint8), ("m2", m2, torch.uint8),
                           ("acc", acc, torch.int64), ("keys", table.keys, torch.int64),
                           ("rows", table.rows, torch.int64),
                           ("flanks", table.flanks, torch.uint8)):
        if x is None:
            continue
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}, got "
                             f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if any(m.dim() != 2 for m in mats) or (m1 is not None and m2 is not None
                                           and m1.shape[0] != m2.shape[0]):
        raise ValueError("m1 and m2 must be (n, width) matrices of the same n")
    if len(acc) != len(table.keys) or len(table.rows) != len(table.keys):
        raise ValueError("keys, rows and acc must have one entry per barcode")
    if table.bc_len > 32:
        raise ValueError("count_match packs at most 32 bases into a key")
    return dev, mats[0].shape[0]


def count_match(table: MatchTable, m1, m2, acc):
    """One batch's test on its device. ``m1`` alone is single-end forward,
    ``m2`` alone single-end reverse, both paired (mate 2's core reverse
    complemented); ``acc`` (int64, one entry a barcode) gains each hit at
    the key's row. Returns ``(idx, counts)`` on the device: ``counts``
    (int32, 2) the number of unmatched eligible rows and of truncated rows;
    ``idx`` (int32, n) the unmatched rows in its first ``counts[0]``
    entries and the truncated rows in its last ``counts[1]``, each list in
    no particular order (:func:`split_rows`)."""
    global launches
    dev, n = _check(table, m1, m2, acc)
    if dev.type == "cpu":
        return count_match_reference(table, m1, m2, acc)
    if dev.type != "cuda":
        raise ValueError(f"count_match runs on cpu or cuda, not {dev}")
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(table, m1, m2, acc, idx, counts, n, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return idx, counts


def _launch(table, m1, m2, acc, idx, counts, n, stream) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = nvcc.launcher("count_match", "count_match_launch",
                           [vp, i64, vp, i64, vp] + [i32] * 7 + [vp] * 3 + [i32, vp, vp, i32, vp])
    rc = launch(
        0 if m1 is None else m1.data_ptr(), 0 if m1 is None else m1.shape[1],
        0 if m2 is None else m2.data_ptr(), 0 if m2 is None else m2.shape[1],
        table.flanks.data_ptr(), *table.lens, *table.starts, table.bc_len,
        table.keys.data_ptr(), table.rows.data_ptr(), acc.data_ptr(), len(table.keys),
        idx.data_ptr(), counts.data_ptr(), n, stream,
    )
    if rc != 0:
        raise RuntimeError(f"count_match kernel launch failed with CUDA error {rc}")


def load(table: MatchTable) -> None:
    """Build and load the kernel and launch it once on no rows, on the
    table's card: a process's first launch loads the module, which belongs
    in set-up, not in the first batch's timed window."""
    dev = table.keys.device
    m = torch.zeros((0, 1), dtype=torch.uint8, device=dev)
    idx = torch.empty(0, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    acc = torch.zeros(len(table.keys), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _launch(table, m, None, acc, idx, counts, 0, torch.cuda.current_stream(dev).cuda_stream)


_CODES = torch.full((256,), 4, dtype=torch.int64)
_CODES[torch.tensor(list(b"ACGT"))] = torch.arange(4)


def _side(m, table: MatchTable, side: int, rev: bool):
    """One mate's test: (truncated, has an N, flanks match, key, pure)."""
    lf, rf = table.lens[2 * side], table.lens[2 * side + 1]
    off = sum(table.lens[: 2 * side])
    start, bc = table.starts[side], table.bc_len
    n, w = m.shape
    W = lf + bc + rf
    trunc = (m != 0).sum(dim=1) < start + W
    has_n = (m == ord("N")).any(dim=1)
    win = torch.zeros((n, W), dtype=torch.uint8, device=m.device)
    lo, hi = min(max(start, 0), w), min(start + W, w)
    if hi > lo:
        win[:, : hi - lo] = m[:, lo:hi]
    fl = table.flanks
    flanks = ((win[:, :lf] == fl[off : off + lf]).all(dim=1)
              & (win[:, W - rf :] == fl[off + lf : off + lf + rf]).all(dim=1))
    codes = _CODES.to(m.device)[win[:, lf : lf + bc].long()]
    if rev:
        codes = codes.flip(1)
        codes = torch.where(codes < 4, 3 - codes, codes)
    pure = (codes < 4).all(dim=1)
    shifts = 2 * torch.arange(bc, device=m.device)
    key = ((codes & 3) << shifts).sum(dim=1)  # disjoint bits: the sum is the or
    return trunc, has_n, flanks, torch.where(pure, key, torch.full_like(key, -1)), pure


def count_match_reference(table: MatchTable, m1, m2, acc):
    """:func:`count_match` in plain torch, on any device, with the same
    contract; each of its lists is in row order."""
    dev, n = _check(table, m1, m2, acc)
    if m1 is not None:
        trunc, has_n, flanks, key, pure = _side(m1, table, 0, False)
        eligible = ~has_n & flanks
        if m2 is not None:
            trunc2, has_n2, flanks2, key2, _ = _side(m2, table, 1, True)
            trunc = trunc | trunc2
            eligible &= ~has_n2 & flanks2 & (key == key2)
    else:
        trunc, has_n, flanks, key, pure = _side(m2, table, 1, True)
        eligible = ~has_n & flanks
    eligible &= ~trunc
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    if len(table.keys):
        at = torch.searchsorted(table.keys, key).clamp_(max=len(table.keys) - 1)
        hit = eligible & pure & (table.keys[at] == key)
        acc.index_add_(0, table.rows[at[hit]], torch.ones_like(at[hit]))
    unmatched = torch.nonzero(eligible & ~hit).flatten()
    truncated = torch.nonzero(trunc).flatten()
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    idx[: len(unmatched)] = unmatched.to(torch.int32)
    idx[n - len(truncated) :] = truncated.to(torch.int32)
    return idx, torch.tensor([len(unmatched), len(truncated)], dtype=torch.int32, device=dev)


def split_rows(idx: np.ndarray, counts) -> tuple[np.ndarray, np.ndarray]:
    """(unmatched, truncated) row indices of one :func:`count_match` output
    on the host, each sorted."""
    n_un, n_tr = int(counts[0]), int(counts[1])
    return np.sort(idx[:n_un]), np.sort(idx[len(idx) - n_tr :])
