"""The port's counterparts of the JAX package's phase-1 microbenchmarks,
``experiments/int8_bench.py``, ``experiments/phase1_ablate.py`` and
``experiments/phase1_bench.py``, on one CUDA card:

    python -m barcoder_tpu_torch.experiments.int8_bench [bf16] [int8]
    python -m barcoder_tpu_torch.experiments.phase1_ablate
    python -m barcoder_tpu_torch.experiments.phase1_bench

Each runs at its script's constants, prints the card's name and power limit
and then one line per variant in the script's format, timed with CUDA events
(the mean of REPS launches after a warm-up). They need a card: without one
they raise SystemExit.

This module makes their inputs from a seed with numpy, as the scripts do, so
that a test can hand the same arrays to the JAX kernels.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from barcoder_tpu_torch.ops.scan_hits import MASK_BIAS


def require_cuda(what: str) -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit(f"{what} needs a CUDA device; none is available")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls after one
    warm-up call (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def print_rate(name: str, ms: float, pairs: int, checksum: float) -> None:
    """One line in phase1_ablate.py's format."""
    per = ms / 1e3
    print(f"{name}: {ms:.2f} ms -> {pairs / per / 1e12:.2f}e12 padded pairs/s "
          f"({2 * 128 * pairs / per / 1e12:.0f} TF-equiv)  sum={checksum:.0f}", flush=True)


def phase1_inputs(n_tiles: int, n_sblocks: int, *, L: int, K: int, P: int, BS_M: int,
                  mask_share: float = 0.0, seed: int = 0):
    """numpy inputs of phase1_ablate.py and phase1_bench.py, drawn from
    ``np.random.default_rng(seed)`` in the scripts' order: thresh (1,) f32
    = L - 3; Q (n_sblocks * BS_M, K) f32 one-hot rows 4j + base of random
    spacers with the constant 1 at column 4L; tiles (n_tiles, 1, P + K / 4)
    int32 random codes; bias (n_tiles, 2, P) f32, MASK_BIAS on a
    ``mask_share`` of the columns (the scripts use 0: all zero)."""
    rng = np.random.default_rng(seed)
    S = n_sblocks * BS_M
    q_codes = rng.integers(0, 4, (S, L)).astype(np.int8)
    q = np.zeros((S, K), np.float32)
    for j in range(L):
        q[np.arange(S), 4 * j + q_codes[:, j]] = 1.0
    q[:, 4 * L] = 1.0
    tiles = rng.integers(0, 4, (n_tiles, 1, P + K // 4)).astype(np.int32)
    bias = np.where(rng.random((n_tiles, 2, P)) < mask_share, MASK_BIAS, 0.0).astype(np.float32)
    return np.array([L - 3], np.float32), q, tiles, bias


def plant_hits(q, tiles, *, L: int, P: int, share: float = 0.25, seed: int = 0) -> None:
    """Give phase1_inputs' arrays hits, in place. The scripts' random
    spacers almost never come within 3 mismatches of a random genome, so
    their counts are all zero; here a ``share`` of Q's rows become genome
    windows of random tiles with ~8% of their bases redrawn, and 5% of the
    rows also carry column 4L + 1, so bias row 4L + 1 of G counts too."""
    rng = np.random.default_rng(seed)
    rows = np.flatnonzero(rng.random(q.shape[0]) < share)
    t = rng.integers(tiles.shape[0], size=rows.size)
    p = rng.integers(P, size=rows.size)
    w = tiles[t[:, None], 0, p[:, None] + np.arange(L)]
    redraw = rng.random(w.shape) < 0.08
    w[redraw] = rng.integers(0, 4, int(redraw.sum()))
    q[rows, : 4 * L] = 0
    q[rows[:, None], 4 * np.arange(L) + w] = 1.0
    q[rng.random(q.shape[0]) < 0.05, 4 * L + 1] = 1.0


def round_bias(bias, *, share: float = 0.3, seed: int = 0) -> None:
    """Give phase1_inputs' bias values that bf16 rounds, in place: on a
    ``share`` of the columns both rows become random values of magnitude
    0.5 to 8 with a random sign (bf16 keeps 8 significant bits of them, so
    every score stays an exact f32), and on another ``share`` row 0 (G row
    4L) becomes -0.0."""
    rng = np.random.default_rng(seed)
    n_tiles, rows, P = bias.shape
    pick = rng.random((n_tiles, P))
    mag = rng.uniform(0.5, 8.0, (n_tiles, rows, P)) * rng.choice([-1.0, 1.0], (n_tiles, rows, P))
    bias[:] = np.where((pick < share)[:, None, :], mag, bias)
    bias[:, 0][(pick >= share) & (pick < 2 * share)] = -0.0


def phase1_tensors(thresh, q, tiles, bias, device):
    """phase1_inputs' arrays as the kernels take them on ``device``: f32,
    bf16, int32, f32."""
    return (torch.from_numpy(thresh).to(device), torch.from_numpy(q).to(device, torch.bfloat16),
            torch.from_numpy(tiles).to(device), torch.from_numpy(bias).to(device))


def int8_inputs(n_tiles: int, n_sblocks: int, *, BS_M: int, K: int, P: int, seed: int = 0):
    """numpy inputs of int8_bench.py: random 0/1 Q (n_sblocks * BS_M, K) and
    G (n_tiles, K, P) as int8, from ``np.random.RandomState(seed).randint``
    (the script draws the same way from numpy's unseeded global state)."""
    rs = np.random.RandomState(seed)
    q = rs.randint(0, 2, (n_sblocks * BS_M, K), dtype=np.int8)
    g = rs.randint(0, 2, (n_tiles, K, P), dtype=np.int8)
    return q, g


def int8_tensors(q, g, dtype, device):
    """int8_inputs' arrays in ``dtype`` (torch.int8 or torch.bfloat16) on
    ``device``."""
    return torch.from_numpy(q).to(device, dtype), torch.from_numpy(g).to(device, dtype)
