"""barcoder_tpu_torch — the PyTorch / CUDA port of ``barcoder_tpu`` for one
NVIDIA H100.

The same workloads from the same inputs to the same outputs, with every
Pallas TPU kernel replaced by a kernel written by hand for Hopper
(``csrc/``) and the rest of the device work in plain torch. The JAX package
stays beside it as the reference. This package imports nothing of it and
never ``jax``: it carries its own copies of the JAX-free modules it needs
(``core``, ``seqio``, ``pipeline.design``, and ``Phases``, ``artifacts`` and
``logger`` in ``utils``), each differing from its original in import lines at
most.

Ported so far: the ``targets`` and ``design`` workloads and their CLIs, on
one card (the dense and the site-compacted scan engine, chosen per scan) and
sharded over several (site and dense engines, serving many libraries, the
older block-max API and the scaling harness); all five TPU kernels of the
repository, the three microbenchmarks' among them. Not yet: the class API,
counting, ``mismatch`` and ``distill``, multi-host.

Layers (bottom-up):
  - ``barcoder_tpu_torch.core`` / ``seqio`` — genome, encoding, PAM and file formats (copies)
  - ``barcoder_tpu_torch.csrc``     — CUDA C++ kernels (sm_90a), built at first use
  - ``barcoder_tpu_torch.ops``      — scan engines on one card (kernel wrappers + nvcc build,
    plain torch scan, numpy oracle)
  - ``barcoder_tpu_torch.parallel`` — meshes, the sharded engines, the scaling harness
  - ``barcoder_tpu_torch.pipeline`` — end-to-end workloads (targets, design)
  - ``barcoder_tpu_torch.cli``      — command-line frontend
  - ``barcoder_tpu_torch.experiments`` — the phase-1 microbenchmarks' entry points
  - ``barcoder_tpu_torch.utils``    — phase timings and profiler, site-table artifacts, logging
"""

__version__ = "0.1.0"
from .cli.main import main
