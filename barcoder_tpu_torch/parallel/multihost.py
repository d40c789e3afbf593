"""Multi-host (multi-process) execution: the port of
``barcoder_tpu/parallel/multihost.py``.

The JAX package joins one process per host into ``jax.distributed`` and
runs the same ``shard_map`` programs over a process-spanning mesh: its
``psum``, ``all_gather`` and ``ppermute`` cross hosts inside every
dispatch, which is why its engines keep every process in lockstep (equal
row windows, padded dispatch buckets, identical branches on every host).

The port's engines are single controllers (``parallel.mesh``): a process
drives only the shards it owns and waits on no other process while it
works. Processes meet over ``torch.distributed`` a few times per call, on
the host, to merge results:

- :func:`allgather_bytes` and :func:`agree_int` (the JAX names) gather a
  small byte string or one integer per process: the scan engines' hit
  lists, the counting CLI's undocumented tally, the checkpoint-resume
  agreement and distill's run manifests;
- :func:`allreduce_sum` adds one int64 host vector over the processes:
  the documented counts, once, at the end of a count.

So nothing here has to run in lockstep between merges, and the row
windows, pad buckets and per-dispatch collectives of the JAX engines have
no counterpart.

The merges run on a **gloo** process group, on host tensors. NCCL would
refuse two ranks on one card ("Duplicate GPU detected"), which is how a
one-card machine runs several processes, and gloo's CUDA support covers
``broadcast`` and ``all_reduce`` but not ``all_gather``. The merges move
kilobytes (80 KB of counts at 10,240 barcodes) against seconds of host
parsing per count, so their transport is not where a count's time goes.

The JAX array-placement helpers (``put_global``, ``put_process_local``,
``fetch_local_rows``) have no counterpart: under a single controller a
process places only its own shards' tensors, with ``.to(device)``.

gloo may write banners to fd 1 from C++ when ranks connect; the CLI
shields its machine-read stdout from them (``cli.main._shield_stdout``).
Library users whose stdout is machine-read should do the same.

:func:`free_port` and :func:`spawn_joined` start K processes on one
machine and wait for them (the scaling harness, ``chip_smoke.py`` and the
tests join their workers that way).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

_ENV_COORD = "BARCODER_TPU_COORDINATOR"
_ENV_NPROC = "BARCODER_TPU_NUM_PROCESSES"
_ENV_PID = "BARCODER_TPU_PROCESS_ID"

_initialized = False
_local_device_ids: list[int] | None = None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    timeout_s: float = 600.0,
) -> bool:
    """Join this process into a multi-process run.

    Arguments fall back to ``BARCODER_TPU_COORDINATOR`` (``host:port`` of
    process 0's rendezvous), ``BARCODER_TPU_NUM_PROCESSES`` and
    ``BARCODER_TPU_PROCESS_ID``. Returns True once a multi-process group is
    (or already was) set up, False for the single-process no-op, so callers
    can use it unconditionally:

        multihost.initialize()          # no-op unless env/args say otherwise
        mesh = make_mesh()              # spans ALL processes' shards

    ``local_device_ids`` names the cards this process drives (default:
    every card it sees). Idempotent: a second call returns True at once.
    """
    global _initialized, _local_device_ids
    if _initialized:
        return True
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None and num_processes is None:
        return False  # single-process run: nothing to do
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"a multi-process run needs {_ENV_COORD}, {_ENV_NPROC} and {_ENV_PID} "
            "(or the matching arguments)"
        )
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=coordinator_address, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s),
    )
    _local_device_ids = None if local_device_ids is None else [int(i) for i in local_device_ids]
    _initialized = True
    # tear the group down before the interpreter does: a gloo group left to
    # the interpreter's exit can abort the process as its threads unwind
    import atexit

    atexit.register(shutdown)
    return True


def shutdown() -> None:
    """Leave the multi-process group (a no-op when none is set up); a later
    ``initialize`` may join a new one."""
    global _initialized, _local_device_ids
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _local_device_ids = None


def local_device_ids() -> list[int] | None:
    """The cards ``initialize`` was told this process drives, or None (all)."""
    return _local_device_ids


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def allgather_bytes(data: bytes) -> list[bytes]:
    """All-gather one variable-length byte string per process; every
    process returns the same K-element list, in process order. Two
    collectives: the lengths, then the payloads padded to the longest.
    Single-process reduces to ``[data]``."""
    if not is_multiprocess():
        return [data]
    import torch.distributed as dist

    k = process_count()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(k)]
    dist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64))
    width = max(max(int(n) for n in lens), 1)
    buf = torch.zeros(width, dtype=torch.uint8)
    buf[: len(data)] = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    bufs = [torch.empty(width, dtype=torch.uint8) for _ in range(k)]
    dist.all_gather(bufs, buf)
    return [b[: int(n)].numpy().tobytes() for b, n in zip(bufs, lens)]


def agree_int(value: int) -> tuple[int, bool]:
    """All-gather one int per process; returns ``(value, True)`` when every
    process reported the same value, else ``(min over processes, False)``.
    The cross-host checkpoint-resume agreement: every process sees the
    same gathered vector, so every process takes the same branch."""
    if not is_multiprocess():
        return value, True
    import torch.distributed as dist

    vals = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count())]
    dist.all_gather(vals, torch.tensor([int(value)], dtype=torch.int64))
    v = [int(x) for x in vals]
    return min(v), len(set(v)) == 1


def allreduce_sum(values: np.ndarray) -> np.ndarray:
    """The sum over processes of one int64 host vector, on every process
    (a copy; ``values`` is left as it is)."""
    out = np.array(values, dtype=np.int64, copy=True)
    if not is_multiprocess():
        return out
    import torch.distributed as dist

    t = torch.from_numpy(out)
    dist.all_reduce(t)
    return t.numpy()


def free_port() -> int:
    """A TCP port that is free on localhost now: take it just before the
    processes that rendezvous on it start."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_joined(cmds, envs, cwd, timeout: float) -> list:
    """Start every command at once (one environment each) and wait for all
    of them within ``timeout`` seconds. When one fails, or the time is up,
    every one still running is killed: the others may wait on it forever.
    Output goes to temporary files, so no process blocks on a full pipe
    while another is waited on. Returns ``(returncode, stdout, stderr,
    seconds)`` per command, ``seconds`` from the start to its exit (None
    if it was killed)."""
    import subprocess
    import tempfile
    import time

    t0 = time.perf_counter()
    files = [(tempfile.TemporaryFile(), tempfile.TemporaryFile()) for _ in cmds]
    procs: list = []
    ends: list = [None] * len(cmds)
    try:
        for cmd, env, (out, err) in zip(cmds, envs, files):
            procs.append(subprocess.Popen(cmd, env=env, cwd=cwd, stdout=out, stderr=err))
        while time.perf_counter() - t0 < timeout:
            for i, p in enumerate(procs):
                if ends[i] is None and p.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            if all(e is not None for e in ends) or any(p.returncode for p in procs):
                break
            time.sleep(0.01)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, (out, err), end in zip(procs, files, ends):
        texts = []
        for fh in (out, err):
            fh.seek(0)
            texts.append(fh.read().decode(errors="replace"))
            fh.close()
        results.append((p.returncode, texts[0], texts[1], end))
    return results
