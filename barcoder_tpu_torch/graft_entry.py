"""One scoring step and a sharded dry run of the PyTorch port: the twin of
the repository's root ``__graft_entry__.py``, which runs the JAX package.

entry() — one scoring step of the main path: the phase-1 hit indicator
    (spacer block x genome tile → per-subtile hit-column counts, with the
    threshold and the PAM mask folded into the product), through
    ``ops.scan_hits.scan_block_hits``: the CUDA kernel on a card, its plain
    torch version on the CPU.

dryrun_multichip(n) — one full sharded scan on an n-shard 1-D mesh (and a
    2-D library x genome mesh of 2 x n/2 shards when n >= 4 is even):
    per-shard strand-fused phase 1, pair compaction, phase 2 and the
    gathered hit list (``parallel.sharded_scan``); then one
    ``ShardedCounter`` step on an n-shard read mesh (each shard matches its
    slice of the reads, the counts summed on the host;
    ``parallel.sharded_count``). The shards repeat the cards there are, so
    a one-card machine puts all n on ``cuda:0``.

Both run on the card unless the caller asks for the CPU: ``device="cpu"``
here, or ``parallel.mesh.set_platform("cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.scan_hits import bias_row, scan_block_hits
from .parallel.mesh import default_device, local_devices


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` is one phase-1 scoring
    step on ``device`` (default: the card; "cpu" when asked), returning
    (1 tile, 8 padded spacer blocks, 1 subtile) f32 hit-column counts."""
    dev = default_device() if device is None else torch.device(device)
    L, K, P, BS_M = 20, 128, 256, 128

    def forward(thresh, q_onehot, tiles, bias_tiles):
        return scan_block_hits(thresh, q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=1,
                               BS_M=BS_M, fold_bias=True)

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=P + K // 4)
    q_codes = rng.integers(0, 4, size=(BS_M, L))
    q_codes[:4] = [codes[p : p + L] for p in (3, 50, 120, 200)]  # four sure hits
    q_oh = np.zeros((BS_M, K), np.float32)
    q_oh[np.arange(BS_M)[:, None], 4 * np.arange(L)[None, :] + q_codes] = 1.0
    q_oh[:, 4 * L] = 1.0  # the folded bias row's constant column
    allowed = torch.from_numpy(rng.random(P) < 0.9)
    allowed[[3, 50, 120, 200]] = True
    example_args = (
        torch.tensor([float(L - 3)], device=dev),
        torch.from_numpy(q_oh).to(dev, torch.bfloat16),
        torch.from_numpy(codes.astype(np.int32)).reshape(1, 1, -1).to(dev),
        bias_row(allowed).reshape(1, 1, P).to(dev),
    )
    return forward, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded scan (1-D, and 2-D when n >= 4 is even) and one
    ShardedCounter step over n shards of ``device`` (default: the cards
    there are, repeated to n; "cpu" when asked)."""
    from .core.encode import decode, encode
    from .core.genome import Contig
    from .parallel.mesh import make_mesh, make_mesh_2d
    from .parallel.sharded_count import ShardedCounter, make_read_mesh
    from .parallel.sharded_scan import sharded_scan
    from .pipeline.heuristic_count import CountConfig

    pool = local_devices() if device is None else [torch.device(device)]
    devices = [pool[i % len(pool)] for i in range(n_devices)]
    rng = np.random.default_rng(0)
    n = 4096
    seq = decode(rng.integers(0, 4, size=n).astype(np.int8))
    contig = Contig(id="DRY0.1", length=n, codes=encode(seq), seq=seq, topology="circular")
    spacers = [seq[100:120], seq[2000:2020]]
    mesh = make_mesh(devices=devices)
    hits = sharded_scan(spacers, contig, 1, pam="N", mesh=mesh, P=256)
    assert len(hits) >= 2, f"planted spacers not found: {len(hits)} hits"
    if n_devices % 2 == 0 and n_devices >= 4:
        # the spacer-library axis sharded on top of the genome axis
        mesh2d = make_mesh_2d(2, n_devices // 2, devices=devices)
        hits2d = sharded_scan(spacers, contig, 1, pam="N", mesh=mesh2d, P=256)
        assert len(hits2d) == len(hits), (len(hits2d), len(hits))

    # the data-parallel counting step: one chunk over a read mesh
    barcodes = ["".join("ACGT"[b] for b in rng.integers(0, 4, 20)) for _ in range(8)]
    pre, lf, rf = "ACGTG", "GGTAGCT", "CTTAAGC"
    reads = [pre + lf + barcodes[int(i)] + rf + "TCCA" for i in rng.integers(0, 8, 64)]
    cfg = CountConfig(
        barcodes=set(barcodes), bc_len=20,
        L_fwd=lf, R_fwd=rf, L_rev=None, R_rev=None,
        L_fwd_start=len(pre), L_rev_start=None, need_swap=False,
    )
    counter = ShardedCounter(cfg, mesh=make_read_mesh(devices=devices))
    counter.process_chunk((reads, None))
    doc, _undoc = counter.results()
    assert sum(doc.values()) == len(reads), doc
