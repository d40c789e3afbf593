"""The port's column-max kernel module (barcoder_tpu_torch.ops.colmax_mma)
held against the TPU kernel of ``experiments/int8_bench.py`` (``kern`` and
its ``pallas_call``, interpret mode), in int8 and in bf16.

The script runs its benchmark at import, so the kernel is loaded from the
unchanged file with ``ast``: only the named function definitions (and, for
int8_bench, the ``f = pl.pallas_call(...)`` statement of ``run``) are
executed, in a namespace that holds the script's module constants at a
small size and a ``pl`` whose ``pallas_call`` runs in interpret mode.
test_torch_phase1_ablate.py and test_torch_phase1_bench.py load theirs with
:func:`load_experiment` too.

Every comparison is EXACT: the products are 0/1, so the sums are small
integers in int32 and in f32.
"""

import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from barcoder_tpu_torch.experiments import int8_inputs, int8_tensors
from barcoder_tpu_torch.ops import colmax_mma

torch.set_num_threads(1)

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"
K = 128


def _interpret_pl():
    """``pallas`` as the scripts import it, with pallas_call in interpret mode."""
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return shim


def load_experiment(script: str, consts: dict, defs=(), inner=None) -> dict:
    """Execute the top-level function definitions ``defs`` of
    ``experiments/<script>.py``, unchanged, in a namespace that holds
    ``consts`` (the module constants and arrays the functions read), and,
    with ``inner = (function, name)``, the statement of that function that
    assigns ``name``. Returns the namespace."""
    path = EXPERIMENTS / f"{script}.py"
    tree = ast.parse(path.read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    body = [funcs[name] for name in defs]
    if inner:
        fn, name = inner
        body += [n for n in funcs[fn].body if isinstance(n, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == name for t in n.targets)]
        assert len(body) == len(defs) + 1, f"{script}.{fn} assigns {name} once"
    ns = dict(consts, functools=functools, np=np, jax=jax, jnp=jnp, pl=_interpret_pl(),
              pltpu=pltpu)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


JAX_TYPES = {"int8": (jnp.int8, jnp.int32), "bf16": (jnp.bfloat16, jnp.float32)}
TORCH_TYPES = {"int8": torch.int8, "bf16": torch.bfloat16}


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("n_tiles,n_sblocks,BS_M,P", [(2, 8, 16, 256), (3, 12, 32, 384)])
def test_colmax_matches_pallas(mode, n_tiles, n_sblocks, BS_M, P):
    """The TPU's stored lanes (0..127 of each (tile, block) row, the block
    axis padded to a multiple of 8 with zero rows) equal the slice of the
    port's full column maxima; the full array equals a numpy product."""
    q, g = int8_inputs(n_tiles, n_sblocks, BS_M=BS_M, K=K, P=P, seed=n_sblocks)
    in_dt, out_dt = JAX_TYPES[mode]
    ns = load_experiment("int8_bench", dict(BS_M=BS_M, K=K, P=P, N_TILES=n_tiles,
                                            N_SB=n_sblocks, out_dt=out_dt),
                         defs=("kern",), inner=("run", "f"))
    want = np.asarray(ns["f"](jnp.asarray(q, in_dt), jnp.asarray(g, in_dt)))

    qt, gt = int8_tensors(q, g, TORCH_TYPES[mode], "cpu")
    out_dtype = colmax_mma.OUT_DTYPE[qt.dtype]
    before = colmax_mma.launches
    full = colmax_mma.colmax(qt, gt, out_dtype, BS_M=BS_M)
    assert colmax_mma.launches == before  # CPU tensors never reach the kernel
    got = colmax_mma.tpu_lanes(full, 128).numpy()
    assert got.shape == want.shape == (n_tiles, -(-n_sblocks // 8) * 8, 128)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert want[:, n_sblocks:].sum() == 0 and want[:, :n_sblocks].min() > 0

    scores = np.einsum("rk,tkp->trp", q.astype(np.int64), g.astype(np.int64))
    ref = scores.reshape(n_tiles, n_sblocks, BS_M, P).max(axis=2)
    assert full.shape == (n_tiles, n_sblocks, P)
    assert np.array_equal(full.numpy().astype(np.int64), ref)


def test_colmax_refuses_mixed_types():
    q, g = int8_inputs(1, 1, BS_M=16, K=K, P=128)
    with pytest.raises(ValueError, match="both"):
        colmax_mma.colmax(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16),
                          torch.int32, BS_M=16)
    with pytest.raises(ValueError, match="int32"):
        colmax_mma.colmax(torch.from_numpy(q), torch.from_numpy(g), torch.float32, BS_M=16)
