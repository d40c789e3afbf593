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

The card kernel reads its operands through a staging that the wrapper and
the kernel share: Q as 64-row chunks of wgmma core matrices
(``scan_hits.chunk_layout``, spacer blocks padded to 64 rows by repeating
their last row) and each thread block's 512-column slab of G transposed to
K-major 16-byte pieces (``g_kmajor`` below: what the kernel's ``stage_g``
writes to shared memory). test_staged_product_matches_pallas
rebuilds the product from those bytes alone (:func:`staged_product`, which
test_torch_phase1_wgmma.py uses for the phase-1 kernel's staging too).

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
from barcoder_tpu_torch.ops.scan_hits import chunk_layout

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


def g_kmajor(g_slab: torch.Tensor) -> torch.Tensor:
    """One thread block's (K, 512) slab of G as the kernel stages it in
    shared memory: K-major core matrices, column n's 16-byte K piece c (16
    int8 or 8 bf16 values of k) at byte c * 512 * 16 + n * 16; returned as
    (K bytes / 16, 512, 16 bytes / element size)."""
    per = 16 // g_slab.element_size()
    return g_slab.reshape(-1, per, g_slab.shape[1]).permute(0, 2, 1).contiguous()


def staged_colmax(q: torch.Tensor, g: torch.Tensor, BS_M: int) -> torch.Tensor:
    """The column maxima as the card kernel gets them, from the staged bytes
    alone: each 512-column slab of G (zero past P) staged by ``g_kmajor``
    (see :func:`staged_product`)."""
    n_tiles, K_, P = g.shape

    def stage(t, p0):
        slab = torch.zeros((K_, 512), dtype=g.dtype)
        slab[:, : min(512, P - p0)] = g[t, :, p0 : p0 + 512]
        return g_kmajor(slab)

    return staged_product(q, stage, n_tiles, P, BS_M)


def staged_product(q: torch.Tensor, stage, n_tiles: int, P: int, BS_M: int) -> torch.Tensor:
    """The column maxima of the wgmma kernels from the bytes they stage:
    Q's chunks read at byte c * 1024 + g * 128 + r * 16 + b for row 8g + r,
    K byte 16c + b; ``stage(t, p0)``, the 512-column slab of tile t from
    column p0 as the kernel writes it to shared memory ((K bytes / 16, 512,
    16 bytes / element size)), read at byte c * 512 * 16 + n * 16 + b for
    column n; one 64-row chunk times one 256-column warpgroup slice at a
    time, the max over a block's (padded) chunks."""
    n_sblocks = q.shape[0] // BS_M
    esize = q.element_size()
    kb = q.shape[1] * esize  # bytes of K
    acc_t = torch.int32 if q.dtype == torch.int8 else torch.float32
    chunks = chunk_layout(q[: n_sblocks * BS_M], BS_M).reshape(-1).view(torch.uint8)
    n_chunks = chunks.numel() // (64 * kb)
    cpb = n_chunks // n_sblocks
    # byte (chunk i, c, g, r, b) -> row-major bytes (i, 8g + r, 16c + b)
    rows = chunks.reshape(n_chunks, kb // 16, 8, 8, 16).permute(0, 2, 3, 1, 4).reshape(
        n_chunks, 64, kb).contiguous().view(q.dtype).to(acc_t)
    out = torch.empty((n_tiles, n_sblocks, P), dtype=acc_t)
    for t in range(n_tiles):
        for p0 in range(0, P, 512):
            staged = stage(t, p0).reshape(-1).view(torch.uint8)
            # byte (c, n, b) -> column-major bytes (n, 16c + b): column n's K values
            cols = staged.reshape(kb // 16, 512, 16).permute(1, 0, 2).reshape(
                512, kb).contiguous().view(q.dtype).to(acc_t)
            for w0 in range(0, min(512, P - p0), 256):
                n = min(256, P - p0 - w0)
                prod = rows @ cols[w0 : w0 + n].T  # (n_chunks, 64, n)
                out[t, :, p0 + w0 : p0 + w0 + n] = prod.reshape(n_sblocks, cpb * 64, n).amax(1)
    return out


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("n_tiles,n_sblocks,BS_M,P", [(2, 8, 16, 256), (3, 12, 32, 384),
                                                     (2, 5, 80, 400), (1, 3, 64, 1024)])
def test_staged_product_matches_pallas(mode, n_tiles, n_sblocks, BS_M, P):
    """The product rebuilt from the kernel's staging (G transposed to
    K-major pieces, Q in core-matrix order, blocks padded to 64 rows) equals
    ``colmax_reference`` over every column and the Pallas kernel's lanes;
    P = 400 leaves a ragged slab, BS_M = 16, 32 and 80 padded blocks."""
    q, g = int8_inputs(n_tiles, n_sblocks, BS_M=BS_M, K=K, P=P, seed=P + BS_M)
    qt, gt = int8_tensors(q, g, TORCH_TYPES[mode], "cpu")
    out_dtype = colmax_mma.OUT_DTYPE[qt.dtype]
    want = colmax_mma.colmax_reference(qt, gt, out_dtype, BS_M=BS_M)
    got = staged_colmax(qt, gt, BS_M)
    assert got.dtype == want.dtype and torch.equal(got, want)

    in_dt, out_dt = JAX_TYPES[mode]
    ns = load_experiment("int8_bench", dict(BS_M=BS_M, K=K, P=P, N_TILES=n_tiles,
                                            N_SB=n_sblocks, out_dt=out_dt),
                         defs=("kern",), inner=("run", "f"))
    lanes = np.asarray(ns["f"](jnp.asarray(q, in_dt), jnp.asarray(g, in_dt)))
    assert np.array_equal(colmax_mma.tpu_lanes(got, 128).numpy(), lanes)


def test_staged_int8_product_on_the_whole_range():
    """int8 is exact for every value, not only 0/1."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(-128, 128, (3 * 48, K)).astype(np.int8))
    g = torch.from_numpy(rng.integers(-128, 128, (2, K, 528)).astype(np.int8))
    want = colmax_mma.colmax_reference(q, g, torch.int32, BS_M=48)
    assert torch.equal(staged_colmax(q, g, 48), want)


def test_colmax_refuses_mixed_types():
    q, g = int8_inputs(1, 1, BS_M=16, K=K, P=128)
    with pytest.raises(ValueError, match="both"):
        colmax_mma.colmax(torch.from_numpy(q), torch.from_numpy(g).to(torch.bfloat16),
                          torch.int32, BS_M=16)
    with pytest.raises(ValueError, match="int32"):
        colmax_mma.colmax(torch.from_numpy(q), torch.from_numpy(g), torch.float32, BS_M=16)
