"""Ablations of the phase-1 hit kernel on one CUDA card: the port of
``experiments/phase1_ablate.py``. Every variant consumes the whole score
matrix through the hit-count epilogue.

  A. G built in the kernel, counts per spacer block   (the real kernel's shape)
  B. G streamed from a prebuilt (T, K, P) array, per block
  C. G built, counts batched over 8 blocks
  D. G streamed, batched

    python -m barcoder_tpu_torch.experiments.phase1_ablate

Prints the card's name and power limit, then per variant the mean
milliseconds over REPS launches after a warm-up, padded (spacer, position)
pairs per second, the bf16 tera-flops the same work would be as a matmul,
and the sum of the counts.
"""

from __future__ import annotations

import sys

from barcoder_tpu_torch.experiments import (
    card_line, cuda_ms, phase1_inputs, phase1_tensors, print_rate, require_cuda,
)
from barcoder_tpu_torch.ops import phase1_variants

L, K, P, SUB, BS_M = 20, 128, 16384, 32, 512
N_TILES, N_SB = 320, 40
REPS = 5
NAMES = {"A": "A build+perstep (real)", "B": "B stream+perstep      ",
         "C": "C build+batched8      ", "D": "D stream+batched8     "}


def main(argv=None) -> int:
    device = require_cuda("phase1_ablate")
    print(card_line(), flush=True)
    th, q, tiles, bias = phase1_tensors(
        *phase1_inputs(N_TILES, N_SB, L=L, K=K, P=P, BS_M=BS_M), device)
    g_all = phase1_variants.build_g_all(tiles, bias, L=L, K=K, P=P)
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    for variant, name in NAMES.items():
        def fn(v=variant):
            return phase1_variants.ablate(v, th, q, tiles, bias, g_all, **kw)

        r = fn()
        print_rate(name, cuda_ms(fn, REPS), N_TILES * N_SB * BS_M * P, float(r.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
