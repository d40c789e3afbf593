"""Plain-torch Hamming scan — the twin of ``barcoder_tpu/ops/ref_scan.py``'s
``jax_scan`` (one-hot matmul formulation).

scores[s, p] = Σ_j <onehot(q[s, j]), onehot(g[p + j])>, computed per
position chunk as a plain GEMM with the same chunking as ``jax_scan``, so
the dense S×N score matrix is never materialized. It is the backend for
hosts without CUDA, and the independent check of the CUDA engine on the
card: it runs on whatever device it is given, and builds its own one-hot
Q rows and G columns, sharing no code with the engine's.

mismatches = L - scores always (an N on either side contributes 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.genome import Contig
from .prep import build_scan_array, revcomp_matrix, site_masks, spacer_matrix
from .types import STRAND_F, STRAND_R, Hits

_BASES = torch.arange(4, dtype=torch.int32)


def _onehot_rows(q_codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """(S, L) spacer codes → (S, 4L) float32 one-hot rows, column 4j + b
    (an N row position stays all zero)."""
    q = torch.from_numpy(np.ascontiguousarray(q_codes, dtype=np.int32)).to(device)
    oh = q[:, :, None] == _BASES.to(device)  # (S, L, 4)
    return oh.reshape(q.shape[0], -1).to(torch.float32)


def _onehot_cols(g_codes: torch.Tensor, L: int, P: int) -> torch.Tensor:
    """(P + L - 1,) genome codes → (4L, P) float32 one-hot columns, row
    4j + b set where g[p + j] == b (N and the sentinel give zero rows)."""
    idx = torch.arange(L, device=g_codes.device)[:, None] + torch.arange(P, device=g_codes.device)
    oh = g_codes[idx][:, None, :] == _BASES.to(g_codes.device)[:, None]  # (L, 4, P)
    return oh.reshape(4 * L, P).to(torch.float32)


def _chunk_hitmask_mm(q_oh_rows, g_codes, mask_chunk, L: int, thresh: int):
    """q_oh_rows (S_pad, 4L) float32 one-hot rows, g_codes (P + L - 1,)
    int32 → (mismatch matrix int32, selected bool) with the site mask fused
    so only PAM-valid positions survive."""
    scores = q_oh_rows @ _onehot_cols(g_codes, L, mask_chunk.shape[0])
    mm = (L - scores).to(torch.int32)
    sel = (mm <= thresh) & mask_chunk[None, :]
    return mm, sel


def torch_scan(
    spacers: list[str] | np.ndarray,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    chunk: int = 1 << 17,
    device: str | torch.device = "cpu",
) -> Hits:
    """Same contract as oracle_scan, via torch on ``device``; hits are
    extracted per position chunk."""
    device = torch.device(device)
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    S, L = q_f.shape
    scan = build_scan_array(contig, L) if S else contig.codes
    n = contig.length
    n_starts = min(n, len(scan) - L + 1) if (S and len(scan) >= L) else 0
    if S == 0 or n_starts <= 0:
        return Hits()
    q_r = revcomp_matrix(q_f)
    mask_f, mask_r = site_masks(contig, L, pam, pam_direction)

    # the chunk geometry of jax_scan: spacer count padded to a power of two
    # (all-N pad rows never match), position chunks at the full chunk width
    # (N codes + False mask), cells per chunk capped at ~2^26
    chunk = min(chunk, max(256, 1 << (n_starts - 1).bit_length()))
    S_pad = max(8, 1 << (S - 1).bit_length())
    chunk = max(1024, min(chunk, (1 << 26) // S_pad))
    pad_rows = np.full((S_pad - S, L), 4, dtype=q_f.dtype)
    q_ohs = {
        strand: _onehot_rows(np.concatenate([q, pad_rows]), device)
        for strand, q in ((STRAND_F, q_f), (STRAND_R, q_r))
    }
    masks = {
        strand: torch.from_numpy(np.asarray(m, dtype=bool)).to(device)
        for strand, m in ((STRAND_F, mask_f), (STRAND_R, mask_r))
    }
    scan_dev = torch.from_numpy(np.ascontiguousarray(scan, dtype=np.int32)).to(device)
    out = []
    for p0 in range(0, n_starts, chunk):
        p1 = min(p0 + chunk, n_starts)
        # one genome-chunk build per chunk — only the PAM mask differs
        # between strands
        g = torch.full((chunk + L - 1,), 4, dtype=torch.int32, device=device)
        g[: p1 + L - 1 - p0] = scan_dev[p0 : p1 + L - 1]
        for strand in (STRAND_F, STRAND_R):
            m = torch.zeros(chunk, dtype=torch.bool, device=device)
            m[: p1 - p0] = masks[strand][p0:p1]
            mm, sel = _chunk_hitmask_mm(q_ohs[strand], g, m, L, int(max_mismatches))
            sp, pos = torch.nonzero(sel, as_tuple=True)
            if len(sp):
                keep = sp < S
                sp, pos = sp[keep], pos[keep]
                out.append(
                    Hits(
                        spacer_idx=sp.cpu().numpy().astype(np.int64),
                        pos=(pos + p0).cpu().numpy().astype(np.int64),
                        strand=np.full(len(pos), strand, np.int8),
                        mismatches=mm[sp, pos].cpu().numpy().astype(np.int32),
                    )
                )
    return Hits.concat(out).sorted()
