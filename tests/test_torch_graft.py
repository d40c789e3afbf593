"""The port's twin of ``__graft_entry__.py`` (barcoder_tpu_torch.graft_entry)
on the CPU, asked for explicitly: ``entry()``'s scoring step against the
JAX package's Pallas kernel in interpret mode on the same inputs, and
``dryrun_multichip(n)`` on n CPU shards, beside the root file's own dry run
on conftest's fake devices. Without a card and without ``device="cpu"``
both refuse. The card's run (the scan_hits kernel) is in
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu.ops.pallas_scan import scan_block_hits as jax_scan_block_hits
from barcoder_tpu_torch import graft_entry
from barcoder_tpu_torch.ops import scan_hits

torch.set_num_threads(1)


def test_entry_matches_the_pallas_kernel():
    fn, args = graft_entry.entry(device="cpu")
    before = scan_hits.launches
    got = fn(*args)
    assert scan_hits.launches == before  # a CPU tensor takes the plain version
    thresh, q, tiles, bias = (a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
                              for a in args)
    want = np.asarray(jax_scan_block_hits(
        jnp.asarray(thresh), jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(tiles),
        jnp.asarray(bias), L=20, K=128, P=256, SUB=1, BS_M=128, fold_bias=True,
        interpret=True))
    assert got.shape == want.shape == (1, 8, 1)
    assert np.array_equal(got.numpy(), want) and want.sum() >= 4


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_cpu_shards(n):
    graft_entry.dryrun_multichip(n, device="cpu")


def test_root_dryrun_still_runs():
    import __graft_entry__ as root

    root.dryrun_multichip(4)


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)
