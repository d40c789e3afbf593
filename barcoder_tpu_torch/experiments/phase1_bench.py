"""The real phase-1 kernel at E. coli bench shapes, and ablations of its
epilogue, on one CUDA card: the port of ``experiments/phase1_bench.py``.

The "real" row times the port's ``scan_hits.scan_block_hits`` (the int8
``wgmma`` kernel of the main path); the rest time the bf16 ``mma.sync``
kernel of ``ops/phase1_variants.py`` with G built in the kernel and the
epilogue cut down: (a) the column maxima, (b) the hit bits, (c) hit counts
batched over 8 spacer blocks, (d) hit counts per block. So the two
tensor-core formulations stand side by side on the same inputs.

    python -m barcoder_tpu_torch.experiments.phase1_bench

Prints the card's name and power limit, then per row the mean milliseconds
over REPS launches after a warm-up, padded pairs per second, the bf16
tera-flops the same work would be as a matmul, and the output's sum.
"""

from __future__ import annotations

import sys

from barcoder_tpu_torch.experiments import (
    card_line, cuda_ms, phase1_inputs, phase1_tensors, print_rate, require_cuda,
)
from barcoder_tpu_torch.ops import phase1_variants, scan_hits

L, K, P, SUB, BS_M = 20, 128, 16384, 32, 512
N_TILES = 320  # E. coli bucketed: 5.24 Mb
S_PAD2 = 20480  # both strands
N_SB = S_PAD2 // BS_M  # 40
REPS = 5
NAMES = {"a": "colmax only (G built)", "b": "hit, no seg (G built)",
         "c": "hit+seg batched8     ", "d": "hit+seg per-step     "}


def main(argv=None) -> int:
    device = require_cuda("phase1_bench")
    print(card_line(), flush=True)
    th, q, tiles, bias = phase1_tensors(
        *phase1_inputs(N_TILES, N_SB, L=L, K=K, P=P, BS_M=BS_M), device)
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    pairs = N_TILES * N_SB * BS_M * P
    rows = {"scan_block_hits (real)": lambda: scan_hits.scan_block_hits(
        th, q, tiles, bias, fold_bias=True, **kw)}
    for variant, name in NAMES.items():
        rows[name] = lambda v=variant: phase1_variants.bench(v, th, q, tiles, bias, **kw)
    for name, fn in rows.items():
        r = fn()
        print_rate(name, cuda_ms(fn, REPS), pairs, float(r.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
