"""Device mesh helpers: the port of ``barcoder_tpu/parallel/mesh.py``.

The distributed model is the JAX package's on one host: genome-axis
sharding over a 1-D ``genome`` mesh axis (each shard scans a contiguous
block of positions), optionally with the spacer library split over a
``library`` axis too, per-shard hit counts merged and hit lists gathered.

Design: a single controller. One process drives every shard of the mesh,
as ``shard_map`` does on one host: a shard is a (device, block) pair, and
the engine launches each shard's work on its device from this process.
``torch.distributed`` comes in only with several hosts. A mesh may repeat
a device: ``[torch.device("cpu")] * 8`` stands in for the JAX tests' 8 fake
host devices, and ``[cuda:0] * 4`` puts four shard boundaries on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

GENOME_AXIS = "genome"
LIBRARY_AXIS = "library"


@dataclass(frozen=True, eq=False)
class Mesh:
    """An array of ``torch.device``s with one name per axis (the shape of
    ``jax.sharding.Mesh`` that the engines read)."""

    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def repeats_a_device(self) -> bool:
        return len({str(d) for d in self.devices.ravel()}) < self.devices.size


def local_devices() -> list[torch.device]:
    """cuda:0..n-1; raises without CUDA. A mesh on the CPU exists only when
    the caller passes CPU devices (``make_mesh(devices=...)``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass the mesh's devices explicitly "
            "(make_mesh(devices=[torch.device('cpu')] * n)) to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_tile(mesh: Mesh) -> int:
    """Tile width P for the sharded engines on ``mesh``: wide tiles for
    cards, small ones for the CPU."""
    return 16384 if mesh.devices.ravel()[0].type == "cuda" else 2048


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the genome axis: the first ``n_devices`` of ``devices``
    (default: every card)."""
    devices = local_devices() if devices is None else list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            # silently truncating mislabels results: the scaling harness
            # would report an 8-device measurement as 16 devices with
            # ~2x-understated efficiency
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(_device_array(devices, (len(devices),)), (GENOME_AXIS,))


def make_mesh_2d(
    n_library: int, n_genome: int | None = None, devices=None
) -> Mesh:
    """2-D ``(library, genome)`` mesh: shard the spacer-library axis when the
    library outgrows one device's memory, with the genome axis sharded
    within each library row."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_genome is None:
        n_genome = len(devices) // n_library
    if n_genome < 1 or n_library * n_genome > len(devices):
        # n_genome == 0 (n_library > device count) would build a degenerate
        # (n_library, 0) mesh that fails far from the cause
        raise ValueError(
            f"mesh {n_library}x{n_genome} needs {max(n_library * n_genome, n_library)} devices,"
            f" have {len(devices)}"
        )
    return Mesh(
        _device_array(devices[: n_library * n_genome], (n_library, n_genome)),
        (LIBRARY_AXIS, GENOME_AXIS),
    )
