"""Device mesh helpers: the port of ``barcoder_tpu/parallel/mesh.py``.

The distributed model is the JAX package's on one host: genome-axis
sharding over a 1-D ``genome`` mesh axis (each shard scans a contiguous
block of positions), optionally with the spacer library split over a
``library`` axis too, per-shard hit counts merged and hit lists gathered.

Design: a single controller per process. One process drives every shard
it owns, as ``shard_map`` does on one host: a shard is a (device, block)
pair, and the engine launches each owned shard's work on its device from
this process. Once ``parallel.multihost.initialize`` has joined several
processes, ``make_mesh`` and ``make_mesh_2d`` span every process's shards,
in process order, and the mesh records each shard's process
(``Mesh.processes``): a process launches only its own shards, and the
engines merge the results over ``torch.distributed`` on the host. Such a
mesh holds a shard of every process (a cut that drops one is refused): a
process without a shard would return nothing, and one outside a spanning
mesh would never join its merges. A mesh
may repeat a device: ``[torch.device("cpu")] * 8`` stands in for the JAX
tests' 8 fake host devices, ``[cuda:0] * 4`` puts four shard boundaries on
one card, and two processes on a one-card machine both put theirs on
``cuda:0``.

The devices are the cards unless the caller asks for the CPU: by passing
CPU devices, or by ``set_platform("cpu")`` (what the CLI does for
``BARCODER_TPU_PLATFORM=cpu``), after which the default devices are
``CPU_SHARDS`` shards of the CPU and ``default_device()`` is the CPU.
Without either, a default mesh raises on a machine without a card.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from . import multihost

GENOME_AXIS = "genome"
LIBRARY_AXIS = "library"
CPU_SHARDS = 4  # shards per process under set_platform("cpu")

_platform: str | None = None


def set_platform(platform: str | None) -> None:
    """Ask for the CPU (``"cpu"``) as the default devices of every mesh and
    counter this process builds, or go back to the cards (None)."""
    global _platform
    if platform not in (None, "cpu", "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}; use 'cpu' or 'cuda'")
    _platform = "cpu" if platform == "cpu" else None


def requested_cpu() -> bool:
    """True once the caller asked for the CPU with ``set_platform("cpu")``."""
    return _platform == "cpu"


def default_device() -> torch.device:
    """The device a one-device engine takes when none is named: the CPU when
    the caller asked for it, else the current card (raises without one)."""
    if requested_cpu():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@dataclass(frozen=True, eq=False)
class Mesh:
    """An array of ``torch.device``s with one name per axis (the shape of
    ``jax.sharding.Mesh`` that the engines read)."""

    devices: np.ndarray  # object array of torch.device, one axis per name
    axis_names: tuple[str, ...]
    # each shard's process, the devices' shape; None: all this process's
    processes: np.ndarray | None = None

    def __post_init__(self):
        if self.processes is None:
            object.__setattr__(self, "processes", np.full(
                self.devices.shape, multihost.process_index(), dtype=np.int64))
        held = set(self.processes.ravel().tolist())
        if multihost.process_index() not in held or (
                len(held) > 1 and held != set(range(multihost.process_count()))):
            # a process without a shard would return no hits, and one left
            # out of a spanning mesh would never join its merges
            raise ValueError(
                f"the mesh holds shards of processes {sorted(held)}: it must hold one of "
                f"this process ({multihost.process_index()}), and, if it spans processes, "
                f"one of each of the {multihost.process_count()}"
            )

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def repeats_a_device(self) -> bool:
        return len({str(d) for d in self.devices.ravel()}) < self.devices.size

    def spans_processes(self) -> bool:
        return len(set(self.processes.ravel().tolist())) > 1

    def is_local(self, index) -> bool:
        """Whether the shard at ``index`` belongs to this process."""
        return int(self.processes[index]) == multihost.process_index()


def local_devices() -> list[torch.device]:
    """This process's devices: its cards (every card it sees, or those
    ``multihost.initialize`` named), or ``CPU_SHARDS`` shards of the CPU
    after ``set_platform("cpu")``. Raises without CUDA otherwise: a mesh on
    the CPU exists only when the caller asks for it."""
    if requested_cpu():
        return [torch.device("cpu")] * CPU_SHARDS
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass the mesh's devices explicitly "
            "(make_mesh(devices=[torch.device('cpu')] * n)) to run on the CPU"
        )
    ids = multihost.local_device_ids()
    ids = range(torch.cuda.device_count()) if ids is None else ids
    return [torch.device("cuda", i) for i in ids]


def default_tile(mesh: Mesh) -> int:
    """Tile width P for the sharded engines on ``mesh``: wide tiles for
    cards, small ones for the CPU."""
    return 16384 if mesh.devices.ravel()[0].type == "cuda" else 2048


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def span_processes(devices) -> tuple[list[torch.device], list[int]]:
    """(devices, process of each) over every process, in process order:
    ``devices`` are this process's; in a multi-process run the others'
    come by an all-gather (a collective: every process calls it)."""
    devices = [torch.device(d) for d in devices]
    if not multihost.is_multiprocess():
        return devices, [multihost.process_index()] * len(devices)
    out, procs = [], []
    for p, blob in enumerate(multihost.allgather_bytes(
            json.dumps([str(d) for d in devices]).encode())):
        names = json.loads(blob)
        out += [torch.device(d) for d in names]
        procs += [p] * len(names)
    return out, procs


def spanning(procs) -> np.ndarray:
    """The shards' processes of a mesh that ``make_mesh``, ``make_mesh_2d``
    or ``make_read_mesh`` cut from ``span_processes``: in a multi-process
    run it must still hold a shard of every process (raises on every
    process alike, before any work)."""
    held = set(procs)
    if multihost.is_multiprocess() and held != set(range(multihost.process_count())):
        raise ValueError(
            f"the mesh's first {len(procs)} shards belong to processes {sorted(held)} only: "
            f"over {multihost.process_count()} processes a mesh needs a shard of each"
        )
    return np.array(procs, dtype=np.int64)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the genome axis: the first ``n_devices`` shards of
    ``devices`` (default: ``local_devices()``). In a multi-process run
    ``devices`` are this process's, and the mesh spans every process's."""
    devices, procs = span_processes(local_devices() if devices is None else devices)
    if n_devices is not None:
        if n_devices > len(devices):
            # silently truncating mislabels results: the scaling harness
            # would report an 8-device measurement as 16 devices with
            # ~2x-understated efficiency
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices, procs = devices[:n_devices], procs[:n_devices]
    return Mesh(_device_array(devices, (len(devices),)), (GENOME_AXIS,), spanning(procs))


def make_mesh_2d(
    n_library: int, n_genome: int | None = None, devices=None
) -> Mesh:
    """2-D ``(library, genome)`` mesh: shard the spacer-library axis when the
    library outgrows one device's memory, with the genome axis sharded
    within each library row. Over several processes the rows follow the
    process order, so the library axis crosses the process boundary."""
    devices, procs = span_processes(local_devices() if devices is None else devices)
    if n_genome is None:
        n_genome = len(devices) // n_library
    if n_genome < 1 or n_library * n_genome > len(devices):
        # n_genome == 0 (n_library > device count) would build a degenerate
        # (n_library, 0) mesh that fails far from the cause
        raise ValueError(
            f"mesh {n_library}x{n_genome} needs {max(n_library * n_genome, n_library)} devices,"
            f" have {len(devices)}"
        )
    n = n_library * n_genome
    return Mesh(
        _device_array(devices[:n], (n_library, n_genome)),
        (LIBRARY_AXIS, GENOME_AXIS),
        spanning(procs[:n]).reshape(n_library, n_genome),
    )
