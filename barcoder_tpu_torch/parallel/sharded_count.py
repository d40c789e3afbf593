"""Data-parallel barcode counting over a read mesh: the port of
``barcoder_tpu/parallel/sharded_count.py``.

The JAX engine shards each dispatched batch's read axis over a 1-D mesh,
exact-matches every shard's rows against the replicated barcode table on
its device (``jnp.dot`` outside Pallas), and merges the per-device count
vectors on the device with ``psum``. Here each batch's raw rows are split
into one contiguous slice per shard this process owns, each slice is
tested on its shard's device by ``CudaCounter``'s shard loop
(``_set_shards``; one ``ops.count_match`` kernel launch a slice: the whole
per-read test and the match into the shard's own int64 accumulator), and
the accumulators are summed on the host at each drain: a ``CudaCounter``
is the one-shard case.

Chunk semantics (flank windows, paired revcomp consistency, N filter, the
truncated-window slow path, undocumented ``seq*`` counting) are
``CudaCounter``'s, so ``VectorCounter``'s: only where the test runs is
sharded.

Across processes (a read mesh that spans them, ``parallel.multihost``),
each process counts only its own reads, and the processes meet once, at
``results()``:

- ``process_matrices``: every process is fed the same chunks and counts
  its own window of each, ``ceil(n / K)`` rows at ``process_index`` (the
  JAX engine's windows, less the all-N padding that kept its collectives
  in lockstep: nothing here runs in lockstep);
- ``feed_owned``: chunk i belongs to process i mod K, which alone parses
  and counts it; the others pass its record count only. Its rows dispatch
  like any others'; ``flush_owned`` dispatches what is buffered (the JAX
  engine's lockstep flush, bucket padding and per-owner row tallies guard
  collectives this engine does not have);
- ``total_reads`` is global on every process by construction, since every
  process sees every chunk's record count; ``owned_reads`` counts the rows
  this process counted itself;
- ``results()`` adds the processes' documented counts and ``owned_reads``
  with one ``allreduce_sum`` of an int64 host vector (B + 1 entries) and
  checks that the owned reads sum to ``total_reads``. It leaves the
  counter's own state local, so a second call, or a checkpoint (which
  drains and saves the local counts, ``_CheckpointState``), never merges
  a count twice. The undocumented tally stays this process's own (the
  union over processes is the one-process tally); ``run_count`` merges it.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..pipeline.heuristic_count import CountConfig, CudaCounter, VectorCounter, _rows
from . import multihost
from .mesh import Mesh, _device_array, local_devices, span_processes, spanning

READS_AXIS = "reads"


def make_read_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the read-batch (data-parallel) axis: the first
    ``n_devices`` shards of ``devices`` (default: ``local_devices()``),
    over every process's once several have joined."""
    devices, procs = span_processes(local_devices() if devices is None else devices)
    if n_devices is not None:
        devices, procs = devices[:n_devices], procs[:n_devices]
    return Mesh(_device_array(devices, (len(devices),)), (READS_AXIS,), spanning(procs))


class ShardedCounter(CudaCounter):
    """CudaCounter with each batch's matching split over the shards of a
    read mesh that this process owns, and, on a mesh that spans processes,
    the documented counts merged over them at ``results()``."""

    def __init__(self, cfg: CountConfig, mesh: Mesh | None = None):
        self._mesh = mesh if mesh is not None else make_read_mesh()
        # a Mesh holds a shard of this process (and, spanning processes, of each)
        local = [dev for idx, dev in np.ndenumerate(self._mesh.devices)
                 if self._mesh.is_local(idx)]
        super().__init__(cfg, device=local[0])
        self.spans_processes = self._mesh.spans_processes()
        self._set_shards(local)
        self.owned_reads = 0  # rows this process counted itself

    # ----- the feeds -----

    def process_matrices(self, m1, m2) -> None:
        """One chunk, fed to every process alike: on a mesh that spans
        processes, this process counts its own window of the rows and adds
        the others' to ``total_reads`` only."""
        n = _rows(m1, m2)
        if not self.spans_processes:
            self.owned_reads += n
            super().process_matrices(m1, m2)
            return
        per = -(-n // multihost.process_count())
        lo = min(multihost.process_index() * per, n)
        hi = min(lo + per, n)
        self.owned_reads += hi - lo
        super().process_matrices(None if m1 is None else m1[lo:hi],
                                 None if m2 is None else m2[lo:hi])
        self.total_reads += n - (hi - lo)

    def feed_owned(self, chunk_idx: int, n_records: int, m1, m2) -> None:
        """Feed one chunk of the shared stream, in chunk order, on every
        process. ``m1``/``m2`` are non-None only on the owning process
        (``chunk_idx % K == process_index``), which counts the chunk; the
        others add its ``n_records`` to ``total_reads``."""
        if m1 is None and m2 is None:
            self.total_reads += n_records
            return
        self.owned_reads += n_records
        # this process's own rows, buffered and dispatched by CudaCounter
        # (not the process window of process_matrices above)
        CudaCounter.process_matrices(self, m1, m2)

    def flush_owned(self) -> None:
        """Dispatch the rows buffered so far (the JAX engine's lockstep
        flush point; here any process may flush on its own)."""
        self._flush_buf()

    def reset(self) -> None:
        """Also rewind ``owned_reads`` (the discard-checkpoints path of the
        multi-host resume agreement restarts the stream from chunk 0)."""
        super().reset()
        self.owned_reads = 0

    def results(self):
        """(doc, undoc) after a drain. On a mesh that spans processes the
        documented counts are the sum over the processes (one all-reduce,
        the counter's own state left local) and the undocumented tally is
        this process's own."""
        self.drain()
        if not self.spans_processes:
            return VectorCounter.results(self)
        merged = multihost.allreduce_sum(np.append(self.doc_counts, self.owned_reads))
        if int(merged[-1]) != self.total_reads:
            raise RuntimeError(
                f"the processes counted {int(merged[-1])} reads of {self.total_reads}: "
                "were they fed the same chunks?"
            )
        doc = Counter({bc: int(c) for bc, c in zip(self.bc_list, merged[:-1]) if c > 0})
        return doc, Counter(self.undoc)
