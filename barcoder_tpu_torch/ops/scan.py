"""Public scan API: dispatches between the CUDA engine, the plain torch
scan and the numpy oracle.

All backends share the contract of ``barcoder_tpu.ops.scan``:

    scan(spacers, contig, max_mismatches, pam, pam_direction) -> Hits

reporting every site on either strand with Hamming distance <= v whose PAM
context matches.

Backends:
  ``cuda``   — the two-phase engine on one card (``cuda_scan``: dense, or
               site-compacted under its ``site_mode="auto"`` rules) with
               the phase-1 CUDA kernel; raises when CUDA is absent or the
               kernel fails to build or launch, and never falls back;
  ``sharded`` — the sharded engine (``parallel.sharded_scan``) over every
               card (``parallel.mesh.make_mesh``), and over every process's
               cards once ``parallel.multihost.initialize`` has joined
               several; raises without a card unless the caller asked for
               the CPU (``parallel.mesh.set_platform("cpu")``);
  ``torch``  — the plain torch scan (``ref_scan.torch_scan``), on the GPU
               when there is one, else on the CPU;
  ``oracle`` — the numpy oracle;
  ``auto``   — ``cuda``, always: without a card it raises, as ``cuda``
               does. A CPU run asks for ``torch`` or ``oracle``.
"""

from __future__ import annotations

import logging
from typing import Literal

import torch

from ..core.genome import Contig, Genome
from .types import Hits

Backend = Literal["auto", "cuda", "sharded", "torch", "oracle"]

_BACKENDS = ("oracle", "torch", "cuda", "sharded")
_log = logging.getLogger(__name__)


def resolve_backend(backend: Backend = "auto") -> str:
    if backend != "auto":
        if backend not in _BACKENDS:
            raise ValueError(
                f"unknown scan backend {backend!r}; choose one of {('auto',) + _BACKENDS}"
            )
        return backend
    _log.info("scan backend auto -> cuda")
    return "cuda"


def _require_cuda(backend: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"scan backend {backend!r} needs a CUDA device; pass --backend torch "
            "(or oracle) to run on the CPU"
        )


def _cpu_requested() -> bool:
    from ..parallel.mesh import requested_cpu

    return requested_cpu()


def _torch_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def scan_contigs(
    spacers,
    contigs: list[Contig],
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    backend: Backend = "auto",
) -> list[Hits]:
    """Batched multi-contig scan; returns Hits in INPUT ORDER. The cuda
    engine shares one library prep across contigs."""
    b = resolve_backend(backend)
    if b == "cuda" or (b == "sharded" and not _cpu_requested()):
        _require_cuda(b)
    if b == "cuda":
        from .cuda_scan import cuda_scan_contigs

        return cuda_scan_contigs(
            spacers, contigs, max_mismatches, pam, pam_direction, device="cuda"
        )
    if b == "sharded":
        from .cuda_scan import MAX_PAM

        # PAMs longer than the PAM spec's slots take the plain torch scan,
        # as the JAX package sends them to jax_scan
        if len(pam) <= MAX_PAM:
            from ..parallel.mesh import default_tile, make_mesh
            from ..parallel.sharded_scan import sharded_scan_contigs

            mesh = make_mesh()
            return sharded_scan_contigs(
                spacers, contigs, max_mismatches, pam, pam_direction, mesh=mesh,
                P=default_tile(mesh),
            )
        b = "torch"
    if b == "torch":
        from .ref_scan import torch_scan

        dev = _torch_device()
        return [
            torch_scan(spacers, c, max_mismatches, pam, pam_direction, device=dev)
            for c in contigs
        ]
    if b == "oracle":
        from .oracle import oracle_scan

        return [
            oracle_scan(spacers, c, max_mismatches, pam, pam_direction)
            for c in contigs
        ]
    raise ValueError(f"unknown scan backend {b!r}")


def scan_contig(
    spacers,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    backend: Backend = "auto",
) -> Hits:
    return scan_contigs(
        spacers, [contig], max_mismatches, pam, pam_direction, backend
    )[0]


def scan_genome(
    spacers,
    genome: Genome,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    backend: Backend = "auto",
) -> dict[str, Hits]:
    """Scan every contig; returns {contig_id: Hits} (see scan_contigs).
    Raises on duplicate contig ids — the dict form cannot represent them
    (use scan_contigs directly for positional results)."""
    ids = [c.id for c in genome.contigs]
    if len(set(ids)) != len(ids):
        raise ValueError(
            "scan_genome requires unique contig ids; use scan_contigs for "
            f"positional results (got duplicates among {ids})"
        )
    hits = scan_contigs(
        spacers, genome.contigs, max_mismatches, pam, pam_direction, backend
    )
    return dict(zip(ids, hits))
