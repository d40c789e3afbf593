"""Multi-shard scaling harness: the port of
``barcoder_tpu/parallel/scaling.py`` (single host).

Times the sharded scan at mesh sizes 1..N and reports throughput and
efficiency against the one-shard run. A mesh of N shards takes N local
devices when there are that many, and otherwise repeats them (several
shards on one card, or on the CPU); the report then sets ``fake_devices``,
because shards that share a device say nothing about scaling, only about
the mechanics.

Engines:
  - ``flagship`` (default): the full ``sharded_scan`` path — strand-fused
    folded-bias hit indicator, per-shard pair compaction and phase 2.
  - ``blockmax``: the previous-generation phase-1-only max-reduce path
    (``sharded_scan_block_max``, the ``scan_max`` kernel), kept for A/B.

Run: ``python -m barcoder_tpu_torch.parallel.scaling [n_bp] [n_spacers]
[--engine flagship|blockmax|both] [--single-chip] [--P N] [--devices 1,2]``;
prints one JSON object.

``--single-chip`` also times the one-device engine (``ops.cuda_scan``) on
a card, so the sharded-vs-single gap is printed directly. Each timed row
reports ``launches``: how many times each CUDA kernel launched while it
was timed (warm-up calls included), so a row that ran the plain torch
version shows zeros.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..ops import scan_hits, scan_max
from .mesh import default_tile, local_devices, make_mesh


def _make_workload(n_bp: int, n_spacers: int, L: int):
    from ..core.encode import decode, encode
    from ..core.genome import Contig

    rng = np.random.default_rng(0)
    seq = decode(rng.integers(0, 4, size=n_bp).astype(np.int8))
    contig = Contig(
        id="SCALE0.1", length=n_bp, codes=encode(seq), seq=seq, topology="circular"
    )
    spacers = [seq[p : p + L] for p in range(64, 64 + n_spacers * 11, 11)][:n_spacers]
    return contig, spacers


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _best_of(fn, repeats):
    """Steady-state wall time: 2 warm calls (kernel build and caches), then
    best-of-N, each call ending in a device synchronise."""
    def timed():
        out = fn()
        _synchronize()
        return out

    timed()
    last = timed()
    dt = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        last = timed()
        dt = min(dt, time.perf_counter() - t0)
    return dt, last


def _time_flagship(contig, spacers, mesh, P, repeats):
    from .sharded_scan import sharded_scan

    dt, hits = _best_of(
        lambda: sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=P),
        repeats,
    )
    return dt, len(hits)


def blockmax_inputs(contig, spacers, L: int, device):
    """The block-max engine's inputs for the harness's workload: (q_oh
    (S_pad, K) bf16 one-hot rows on ``device``, scan codes, an all-allowed
    start mask, K)."""
    from ..ops.cuda_scan import onehot_rows
    from ..ops.prep import build_scan_array, spacer_matrix
    from ..ops.scan_hits import BS, _cdiv

    K = max(_cdiv(4 * L, 128) * 128, 128)
    q_f = spacer_matrix(spacers)
    S_pad = max(_cdiv(len(spacers), BS) * BS, BS)
    q_oh = np.zeros((S_pad, K), dtype=np.float32)
    q_oh[: len(spacers)] = onehot_rows(q_f, K)
    q_dev = torch.from_numpy(q_oh).to(device, torch.bfloat16)
    scan = build_scan_array(contig, L).astype(np.int32)
    mask = np.ones(contig.length, dtype=np.int32)
    return q_dev, scan, mask, K


def _time_blockmax(contig, spacers, mesh, P, L, repeats):
    from .sharded_scan import sharded_scan_block_max

    q_dev, scan, mask, K = blockmax_inputs(contig, spacers, L, mesh.devices.ravel()[0])
    dt, _ = _best_of(
        lambda: sharded_scan_block_max(q_dev, scan, mask, mesh, L=L, K=K, P=P),
        repeats,
    )
    return dt, None


def _time_single_chip(contig, spacers, repeats):
    """The one-device engine on a card (both strands, full extraction)."""
    from ..ops.cuda_scan import cuda_scan

    dt, hits = _best_of(
        lambda: cuda_scan(spacers, contig, 1, pam="NGG", device="cuda"), repeats
    )
    return dt, len(hits)


def _launches() -> dict:
    return {"scan_hits": scan_hits.launches, "scan_max": scan_max.launches}


def _launched_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _launches().items()}


def measure_scaling(
    n_bp: int = 1 << 21,
    n_spacers: int = 1024,
    L: int = 20,
    P: int | None = None,
    repeats: int = 3,
    device_counts=None,
    engine: str = "flagship",
    single_chip: bool = False,
) -> dict:
    """Time ``engine`` ("flagship", "blockmax" or "both") on meshes of
    ``device_counts`` shards over the local devices (a mesh larger than
    the pool repeats its devices)."""
    pool = local_devices()
    platform = pool[0].type
    if device_counts is None:
        device_counts = sorted({1, 2, len(pool)} & set(range(1, len(pool) + 1)))
    meshes = {nd: make_mesh(devices=[pool[i % len(pool)] for i in range(nd)])
              for nd in device_counts}
    if P is None:
        P = default_tile(meshes[device_counts[0]])

    contig, spacers = _make_workload(n_bp, n_spacers, L)
    positions = 2 * len(spacers) * n_bp  # both strands

    fake = platform == "cpu" or any(m.repeats_a_device() for m in meshes.values())
    engines = ["flagship", "blockmax"] if engine == "both" else [engine]
    out = {
        "platform": platform,
        "device_kind": torch.cuda.get_device_name(0) if platform == "cuda" else "cpu",
        "genome_bp": n_bp,
        "spacers": len(spacers),
        "fake_devices": fake,
        "note": (
            "shards share a device (the CPU, or several shards of one card) — "
            "efficiency numbers are NOT meaningful, only the mechanics"
            if fake
            else "one card per shard"
        ),
    }
    for eng in engines:
        results = []
        base_rate = None
        for nd in device_counts:
            mesh = meshes[nd]
            before = _launches()
            if eng == "flagship":
                dt, n_hits = _time_flagship(contig, spacers, mesh, P, repeats)
            else:
                dt, n_hits = _time_blockmax(contig, spacers, mesh, P, L, repeats)
            rate = positions / dt
            if base_rate is None:
                base_rate = rate
            results.append(
                {
                    "devices": nd,
                    "seconds": dt,
                    "spacer_positions_per_s": rate,
                    "per_device_rate": rate / nd,
                    "speedup": rate / base_rate,
                    "efficiency": rate / (base_rate * nd),
                    **({"hits": n_hits} if n_hits is not None else {}),
                    "launches": _launched_since(before),
                }
            )
        out[eng] = results
    if single_chip and platform != "cuda":
        # the one-device engine's kernel runs on a card only; timing its
        # plain CPU version would time the stand-in, not the engine
        out["single_chip"] = {"skipped": "no CUDA device (the kernel has no CPU mode)"}
    elif single_chip:
        before = _launches()
        dt, n_hits = _time_single_chip(contig, spacers, repeats)
        out["single_chip"] = {
            "seconds": dt,
            "spacer_positions_per_s": positions / dt,
            "hits": n_hits,
            "launches": _launched_since(before),
        }
        if "flagship" in out:
            one_dev = out["flagship"][0]["per_device_rate"]
            out["sharded_vs_single_chip"] = one_dev / (positions / dt)
    return out


def _take(args: list, flag: str):
    """Remove ``flag VALUE`` from args and return VALUE (None if absent)."""
    if flag not in args:
        return None
    i = args.index(flag)
    value = args[i + 1]
    del args[i : i + 2]
    return value


def main(argv=None) -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    engine = _take(args, "--engine") or "flagship"
    P = _take(args, "--P")
    counts = _take(args, "--devices")
    single = "--single-chip" in args
    if single:
        args.remove("--single-chip")
    n_bp = int(args[0]) if args else 1 << 21
    n_spacers = int(args[1]) if len(args) > 1 else 1024
    print(
        json.dumps(
            measure_scaling(
                n_bp=n_bp, n_spacers=n_spacers, engine=engine, single_chip=single,
                P=int(P) if P else None,
                device_counts=[int(x) for x in counts.split(",")] if counts else None,
            ),
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
