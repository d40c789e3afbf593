"""Column max of a 0/1 product in int8 (wgmma s8 -> s32) against bf16
(wgmma bf16 -> f32) on one CUDA card: the port of ``experiments/int8_bench.py``.

    python -m barcoder_tpu_torch.experiments.int8_bench [bf16] [int8]

Prints the card's name and power limit, then per mode the kernel's mean
milliseconds over REPS launches after a warm-up, its rate in tera-operations
per second, and a checksum (out[0, 0, 0]).
"""

from __future__ import annotations

import sys

import torch

from barcoder_tpu_torch.experiments import card_line, cuda_ms, int8_inputs, int8_tensors, require_cuda
from barcoder_tpu_torch.ops import colmax_mma

BS_M, K, P = 512, 128, 16384
N_TILES, N_SB = 16, 40
REPS = 10
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def run(dtype_name: str, device) -> dict:
    dtype = DTYPES[dtype_name]
    q, g = int8_tensors(*int8_inputs(N_TILES, N_SB, BS_M=BS_M, K=K, P=P), dtype, device)
    out_dtype = colmax_mma.OUT_DTYPE[dtype]
    r = colmax_mma.colmax(q, g, out_dtype, BS_M=BS_M)
    ms = cuda_ms(lambda: colmax_mma.colmax(q, g, out_dtype, BS_M=BS_M), REPS)
    ops = 2 * N_TILES * N_SB * BS_M * K * P
    chk = int(r[0, 0, 0])
    print(f"{dtype_name}: {ms:.2f} ms/iter -> {ops / (ms / 1e3) / 1e12:.1f} T/s (chk {chk})",
          flush=True)
    return dict(ms=ms, ops_per_s=ops / (ms / 1e3), checksum=chk)


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or ["bf16", "int8"]
    bad = [n for n in names if n not in DTYPES]
    if bad:
        raise SystemExit(f"unknown mode(s) {bad}; choose from {sorted(DTYPES)}")
    device = require_cuda("int8_bench")
    print(card_line(), flush=True)
    for name in names:
        run(name, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
