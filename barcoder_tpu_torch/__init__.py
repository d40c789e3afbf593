"""barcoder_tpu_torch — the PyTorch / CUDA port of ``barcoder_tpu`` for one
NVIDIA H100.

The same workloads from the same inputs to the same outputs, with every
Pallas TPU kernel replaced by a kernel written by hand for Hopper
(``csrc/``) and the rest of the device work in plain torch. The JAX package
stays beside it as the reference. This package imports nothing of it and
never ``jax``: it carries its own copies of the JAX-free modules it needs
(``core``, ``seqio``, and ``Phases`` in ``utils.profiling``), each differing
from its original in import lines at most.

Ported so far: the ``targets`` workload on the dense scan engine.

Layers (bottom-up):
  - ``barcoder_tpu_torch.core`` / ``seqio`` — genome, encoding, PAM and file formats (copies)
  - ``barcoder_tpu_torch.csrc``     — CUDA C++ kernels (sm_90a), built at first use
  - ``barcoder_tpu_torch.ops``      — scan engine (CUDA kernel + plain torch + numpy oracle)
  - ``barcoder_tpu_torch.pipeline`` — end-to-end workloads (targets)
  - ``barcoder_tpu_torch.cli``      — command-line frontend
"""

__version__ = "0.1.0"
from .cli.main import main
