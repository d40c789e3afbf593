"""Genome-axis sharded scan over a 1-D or 2-D mesh: the port of
``barcoder_tpu/parallel/sharded_scan.py``'s dense engine (``sharded_scan``)
and its older block-max API (``sharded_scan_block_max``).

Sharding design, as in the JAX package:

  - the genome position axis is split into contiguous blocks of B starts,
    one per genome shard; a shard also needs the first ``halo`` codes of
    the next shard's block, so windows crossing the block boundary score
    correctly (the circular wrap halo itself is in the scan array,
    ``build_scan_array``);
  - on a 2-D ``(library, genome)`` mesh the spacer one-hot rows are split
    over the library axis too;
  - phase 1 per shard is the strand-fused folded-bias hit indicator
    (``ops.scan_hits.scan_block_hits``, the CUDA kernel on a card): one
    launch scores both strands, with the per-strand PAM masks riding in the
    spare G rows; L = 32 leaves no spare row and takes one additive launch
    per strand;
  - phase 2 re-scores each shard's nonzero (subtile, spacer-block) pairs on
    its own device and decodes global positions as ``d * B + column``.

What the port does differently, and why:

  - one process drives every shard (``parallel.mesh``): each shard's halo
    comes straight from the host, where the whole genome already is, in
    place of the JAX ring ``ppermute``. Shard d gets the first ``halo``
    codes of shard (d + 1) mod n_gen, exactly what the ring delivers, so
    the last shard reads shard 0's codes (only masked starts ever reach
    them, but ``sharded_scan_block_max`` reports those starts' maxima too);
  - the fixed-capacity machinery is gone (``pair_cap`` / ``hit_cap``, the
    overflow header, ``_grow_caps`` and the ``_CAPS_MEMO``): phase 1's pairs
    and phase 2's hits are compacted with ``torch.nonzero``, which is exact,
    so nothing can overflow and nothing is retried; hits are decoded on the
    device and gathered on the host, in place of the packed ``all_gather``;
  - only the dense engine is ported. ``site_mode`` "auto" and "never" both
    take it, which gives the Hits the JAX site engine gives; "always"
    raises (ROADMAP module item 4).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..core.genome import Contig
from ..ops.cuda_scan import (
    _compact_pairs, _content_digest, _score_pairs, _split_pairs,
    _tiles_device_impl, onehot_rows,
)
from ..ops.prep import build_scan_array, revcomp_matrix, site_masks, spacer_matrix
from ..ops.scan_hits import BS, MASK_BIAS, _cdiv, bias_row, scan_block_hits
from ..ops.scan_max import scan_block_max
from ..ops.types import STRAND_F, STRAND_R, Hits
from .mesh import GENOME_AXIS, LIBRARY_AXIS, Mesh, make_mesh

_MAX_SPACER_LEN = 63  # the JAX engine's packed hit word holds mm in 6 bits


def _mesh_dims(mesh: Mesh) -> tuple[int, int]:
    """(n_library, n_genome) shard counts of ``mesh`` (1-D meshes have no
    library axis → n_library=1)."""
    shape = mesh.shape
    return shape.get(LIBRARY_AXIS, 1), shape[GENOME_AXIS]


def _grid(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as an (n_library, n_genome) object array."""
    return mesh.devices.reshape(_mesh_dims(mesh))


def _check_spacer_len(q_f: np.ndarray) -> None:
    """The JAX engine packs mismatch counts into 6 bits and refuses spacers
    past 63 nt; the port keeps that contract on every entry path."""
    if q_f.shape[0] and q_f.shape[1] > _MAX_SPACER_LEN:
        raise ValueError(
            f"sharded engine supports spacers up to {_MAX_SPACER_LEN} nt "
            f"(got {q_f.shape[1]})"
        )


def _phase2_geom(P: int, sub_width: int) -> tuple[int, int]:
    """(SUB, P2) subtile geometry with P2 * SUB == P enforced up front: the
    decode reconstructs columns as tile*P + sub*P2 + lane, so a non-divisor
    sub_width would mis-map positions."""
    SUB = max(P // min(sub_width, P), 1)
    P2 = P // SUB
    if SUB * P2 != P:
        raise ValueError(
            f"sub_width={sub_width} yields SUB={SUB} which does not divide "
            f"P={P}; pick a sub_width such that P // sub_width divides P "
            f"(powers of two always work)"
        )
    return SUB, P2


def _pair_chunk(BS_M: int, P2: int) -> int:
    """Pairs per phase-2 batch: bounds the (batch, BS_M, P2) f32 score
    transient to ~1 GiB (the JAX engine's ``_pair_chunk``)."""
    pc = (1 << 28) // max(BS_M * P2, 1)
    return max(256, 1 << max(pc.bit_length() - 1, 0))


def _host_onehot(q_codes: np.ndarray, K: int, L: int, fold: bool, bias_col: int):
    """(rows, K) f32 one-hot with the folded-bias constant-1 column."""
    oh = onehot_rows(q_codes, K)
    if fold:
        oh[:, 4 * L + bias_col] = 1.0
    return oh


@dataclass(frozen=True)
class _Geom:
    """Static geometry of one dense sharded scan (the JAX engine's)."""

    S: int
    L: int
    K: int
    BS_M: int
    n_starts: int
    n_lib: int
    n_gen: int
    P: int
    SUB: int
    P2: int
    B: int  # starts per genome shard, a multiple of P
    S_loc: int  # spacer rows per library shard and strand

    @property
    def halo(self) -> int:
        return self.K // 4

    @property
    def fused(self) -> bool:  # both strands in one launch: two spare G rows
        return 4 * self.L + 2 <= self.K

    @property
    def fold(self) -> bool:  # the bias rides in the spare G rows
        return 4 * self.L < self.K

    @property
    def R(self) -> int:  # bias rows per strand job
        return 2 if self.fused else 1

    @property
    def half_blocks(self) -> int:  # forward spacer blocks of a fused shard
        return self.S_loc // self.BS_M

    @property
    def n_sblocks_loc(self) -> int:
        return self.R * self.S_loc // self.BS_M


def _geometry(q_shape, contig: Contig, mesh: Mesh, P: int, sub_width: int) -> _Geom | None:
    """The scan's geometry, or None when there is nothing to scan."""
    n_lib, n_gen = _mesh_dims(mesh)
    S, L = q_shape
    n = contig.length
    # len(build_scan_array(contig, L)) without building it: a repeat scan
    # does no genome-proportional host work past the content digest
    scan_len = n + (L - 1) if (contig.circular and L > 1) else n
    n_starts = min(n, scan_len - L + 1) if scan_len >= L else 0
    if n_starts <= 0 or S == 0:
        return None
    K = max(_cdiv(4 * L, 128) * 128, 128)
    SUB, P2 = _phase2_geom(P, sub_width)
    if P2 < K // 4:
        raise ValueError(f"subtile width {P2} must cover the halo {K // 4}")
    BS_M = 512 if S >= 2048 else (256 if S >= 512 else BS)
    # B is sized so that n_gen * B >= n_starts + halo: every code a valid
    # window reads lies inside the blocks, and the halo after the last
    # block (shard 0's codes) is read only by masked starts
    B = _cdiv(n_starts + K // 4, n_gen * P) * P
    S_loc = _cdiv(S, n_lib * BS_M) * BS_M
    return _Geom(S=S, L=L, K=K, BS_M=BS_M, n_starts=n_starts, n_lib=n_lib,
                 n_gen=n_gen, P=P, SUB=SUB, P2=P2, B=B, S_loc=S_loc)


# --- the scan's state: numpy in the JAX engine's layout, then per shard -----

@dataclass
class ShardState:
    """The dense sharded scan's inputs as numpy arrays in the JAX engine's
    layout (``sharded_scan.py:1015-1034``, :1122-1158):

    codes   (n_gen, B) int8 genome codes, one block per genome shard, N-padded;
    ok      per strand job, (n_gen, R, B) int8 PAM/site masks (zero past
            n_starts); R = 2 (forward, reverse) for the fused job;
    q       per strand job, (n_lib * R * S_loc, K) float32 one-hot rows:
            library shard i holds rows [i * R * S_loc, (i + 1) * R * S_loc),
            its forward rows over its reverse rows when fused, each with
            its folded-bias constant 1 (column 4L, or 4L + 1 for reverse);
    strands per strand job, None (fused) or the job's strand.
    """

    codes: np.ndarray
    ok: list
    q: list
    strands: list


@dataclass
class ShardTensors:
    """A ShardState on the mesh: {(library shard, genome shard): tensor on
    that shard's device}. codes holds block d followed by its ``halo`` ring
    codes (the first codes of block (d + 1) mod n_gen); ok and q hold one
    such dict per strand job. Shards on one device share their tensors."""

    codes: dict
    ok: list
    q: list
    strands: list


def _codes_blocks(contig: Contig, g: _Geom) -> np.ndarray:
    scan = build_scan_array(contig, g.L)
    total = g.n_gen * g.B
    codes = np.full(total, 4, dtype=np.int8)
    usable = min(len(scan), total)
    codes[:usable] = scan[:usable]
    return codes.reshape(g.n_gen, g.B)


def _ok_blocks(contig: Contig, pam: str, pam_direction: str, g: _Geom) -> list:
    def blocked(mask):
        ok = np.zeros(g.n_gen * g.B, dtype=np.int8)
        ok[: g.n_starts] = mask[: g.n_starts]
        return ok

    def per_shard(rows):  # (R, n_gen * B) → (n_gen, R, B)
        return np.ascontiguousarray(rows.reshape(-1, g.n_gen, g.B).transpose(1, 0, 2))

    mask_f, mask_r = site_masks(contig, g.L, pam, pam_direction)
    if g.fused:
        return [per_shard(np.stack([blocked(mask_f), blocked(mask_r)]))]
    return [per_shard(blocked(mask_f)[None]), per_shard(blocked(mask_r)[None])]


def _q_onehots(q_f: np.ndarray, g: _Geom) -> list:
    q_pad = np.full((g.n_lib * g.S_loc, g.L), 4, dtype=np.int8)
    q_pad[: g.S] = q_f
    q_fwd = _host_onehot(q_pad, g.K, g.L, g.fold, 0)
    q_rev = _host_onehot(revcomp_matrix(q_pad), g.K, g.L, g.fold, 1 if g.fused else 0)
    if not g.fused:
        return [q_fwd, q_rev]
    # library shard i: its forward rows, then its reverse rows
    S_loc = g.S_loc
    stacked = np.stack([q_fwd.reshape(g.n_lib, S_loc, g.K), q_rev.reshape(g.n_lib, S_loc, g.K)],
                       axis=1)
    return [stacked.reshape(g.n_lib * 2 * S_loc, g.K)]


def _strands(g: _Geom) -> list:
    return [None] if g.fused else [STRAND_F, STRAND_R]


def shard_state(spacers, contig: Contig, pam: str = "", pam_direction: str = "downstream",
                mesh: Mesh | None = None, P: int = 2048, sub_width: int = 512):
    """The :class:`ShardState` of ``sharded_scan(spacers, contig, v, pam,
    pam_direction, mesh, P, sub_width)``, or None when there is nothing to
    scan (no spacers, or a contig shorter than the spacers)."""
    mesh = make_mesh() if mesh is None else mesh
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    g = _geometry(q_f.shape, contig, mesh, P, sub_width)
    if g is None:
        return None
    return ShardState(codes=_codes_blocks(contig, g), ok=_ok_blocks(contig, pam, pam_direction, g),
                      q=_q_onehots(q_f, g), strands=_strands(g))


def _per_shard(mesh: Mesh, axis: str, make) -> dict:
    """{(li, d): make(i) on the shard's device} with i the shard's index on
    ``axis``; one tensor per (device, i), shared by the shards that repeat
    a device."""
    made, out = {}, {}
    for (li, d), dev in np.ndenumerate(_grid(mesh)):
        i = d if axis == GENOME_AXIS else li
        key = (str(dev), i)
        if key not in made:
            made[key] = make(i).to(dev)
        out[li, d] = made[key]
    return out


def _from_host(arr: np.ndarray) -> torch.Tensor:
    # a C-contiguous copy: arrays fetched from JAX are read-only
    return torch.from_numpy(np.array(arr, order="C", copy=True))


def _codes_to_shards(codes: np.ndarray, mesh: Mesh, halo: int) -> dict:
    n_gen = codes.shape[0]
    return _per_shard(mesh, GENOME_AXIS, lambda d: _from_host(
        np.concatenate([codes[d], codes[(d + 1) % n_gen][:halo]])))


def _ok_to_shards(ok: np.ndarray, mesh: Mesh) -> dict:
    return _per_shard(mesh, GENOME_AXIS, lambda d: _from_host(ok[d].astype(np.int8)))


def _q_to_shards(q: np.ndarray, mesh: Mesh) -> dict:
    rows = q.shape[0] // _mesh_dims(mesh)[0]
    return _per_shard(mesh, LIBRARY_AXIS, lambda li: _from_host(
        np.asarray(q[li * rows : (li + 1) * rows], np.float32)).to(torch.bfloat16))


def shard_state_from_numpy(state: ShardState, mesh: Mesh) -> ShardTensors:
    """A :class:`ShardState` (the port's, or arrays rebuilt from the JAX
    engine; bf16 q may come as float32 or as ml_dtypes.bfloat16) → the
    per-shard tensors the engine runs on, next to
    ``ops.cuda_scan.state_from_numpy`` for the one-device engine."""
    halo = state.q[0].shape[1] // 4
    return ShardTensors(
        codes=_codes_to_shards(state.codes, mesh, halo),
        ok=[_ok_to_shards(ok, mesh) for ok in state.ok],
        q=[_q_to_shards(q, mesh) for q in state.q],
        strands=list(state.strands),
    )


# --- content-keyed device caches ---------------------------------------------

def _nbytes(v) -> int:
    seen, total = set(), 0
    stack = [v]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


class _ShardCache(OrderedDict):
    """LRU of per-shard device tensors keyed by content digest, geometry and
    the mesh's device list: a repeat scan of one genome and library over
    one mesh builds and ships nothing. Bounded by entries and by bytes, so
    a few large libraries cannot pin device memory; ``hits`` and
    ``misses`` count lookups."""

    def __init__(self, max_entries: int = 8, max_bytes: int = 1 << 30):
        super().__init__()
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.nbytes: dict = {}
        self.hits = self.misses = 0

    def get_or_put(self, key, build):
        if key in self:
            self.move_to_end(key)
            self.hits += 1
            return self[key]
        value = build()
        self.misses += 1
        self[key] = value
        self.nbytes[key] = _nbytes(value)
        while len(self) > 1 and (len(self) > self.max_entries
                                 or sum(self.nbytes.values()) > self.max_bytes):
            old, _ = self.popitem(last=False)
            self.nbytes.pop(old)
        return value


_GENOME_SHARD_CACHE = _ShardCache()
# sized for a serving set of libraries, not just one
_Q_SHARD_CACHE = _ShardCache(max_entries=32)


def _mesh_key(mesh: Mesh) -> tuple:
    return tuple(mesh.shape.items()), tuple(str(d) for d in mesh.devices.ravel())


def _device_state(q_f, contig: Contig, pam: str, pam_direction: str, mesh: Mesh,
                  g: _Geom) -> ShardTensors:
    """The scan's ShardTensors from the caches, built and shipped on a miss."""
    mkey = _mesh_key(mesh)
    genome = (_content_digest(contig.codes), contig.id, contig.length,
              bool(contig.circular), g.L, g.n_gen, g.B, mkey)
    # the codes blocks do not depend on the PAM; only the masks do
    codes = _GENOME_SHARD_CACHE.get_or_put(
        ("codes", genome), lambda: _codes_to_shards(_codes_blocks(contig, g), mesh, g.halo))
    ok = _GENOME_SHARD_CACHE.get_or_put(
        ("ok", genome, pam, pam_direction),
        lambda: [_ok_to_shards(a, mesh) for a in _ok_blocks(contig, pam, pam_direction, g)])
    q = _Q_SHARD_CACHE.get_or_put(
        ("q", _content_digest(q_f), q_f.shape, g.S_loc, g.n_lib, mkey),
        lambda: [_q_to_shards(a, mesh) for a in _q_onehots(q_f, g)])
    return ShardTensors(codes=codes, ok=ok, q=q, strands=_strands(g))


# --- the dense engine --------------------------------------------------------

def _phase1(codes, ok, q, thresh, g: _Geom):
    """One shard's phase 1: its tiles and bias built on its device, then the
    hit-indicator kernel (plain torch on the CPU)."""
    tiles = _tiles_device_impl(codes, n_starts=g.B, P=g.P, halo=g.halo)
    bias = bias_row(ok > 0)
    bias = bias.reshape(g.R, g.B // g.P, g.P).transpose(0, 1).contiguous()
    return scan_block_hits(thresh, q, tiles, bias, L=g.L, K=g.K, P=g.P, SUB=g.SUB,
                           BS_M=g.BS_M, fold_bias=g.fold)


def _phase2(pairs, codes, ok, q, li: int, d: int, strand, g: _Geom, v: int) -> Hits:
    """One shard's phase 2: re-score its pairs in batches of
    ``_pair_chunk`` and decode the hits to global (spacer, position)."""
    if len(pairs) == 0:
        return Hits()
    t_idx, s_idx = _split_pairs(pairs, _cdiv(g.n_sblocks_loc, 8) * 8, g.SUB)
    rev = s_idx >= g.half_blocks if g.fused else torch.zeros_like(s_idx, dtype=torch.bool)
    tiles2 = _tiles_device_impl(codes, n_starts=g.B, P=g.P2, halo=g.halo)[:, 0, :]
    ok_t = (ok > 0).reshape(g.R, -1, g.P2)
    q_blocks = q.reshape(-1, g.BS_M, g.K)
    chunk = _pair_chunk(g.BS_M, g.P2)
    out = []
    for c0 in range(0, len(pairs), chunk):
        tc, sc, rc = t_idx[c0 : c0 + chunk], s_idx[c0 : c0 + chunk], rev[c0 : c0 + chunk]
        mask = torch.where(rc[:, None], ok_t[-1][tc], ok_t[0][tc])
        b, row, col, mm = _score_pairs(q_blocks[sc], tiles2[tc], mask, L=g.L, K=g.K,
                                       P=g.P2, thresh=v)
        sp_local = (sc[b] - rc[b].long() * g.half_blocks) * g.BS_M + row
        spacer = li * g.S_loc + sp_local
        pos = d * g.B + tc[b] * g.P2 + col
        keep = (sp_local < g.S_loc) & (spacer < g.S) & (pos < g.n_starts)
        if strand is None:
            strands = torch.where(rc[b], STRAND_R, STRAND_F)
        else:
            strands = torch.full_like(pos, strand)
        out.append(Hits(
            spacer_idx=spacer[keep].cpu().numpy().astype(np.int64),
            pos=pos[keep].cpu().numpy().astype(np.int64),
            strand=strands[keep].cpu().numpy().astype(np.int8),
            mismatches=mm[keep].cpu().numpy().astype(np.int32),
        ))
    return Hits.concat(out)


def _run(st: ShardTensors, g: _Geom, mesh: Mesh, v: int) -> Hits:
    grid = _grid(mesh)
    thresh = {str(dev): torch.full((1,), float(g.L - v), dtype=torch.float32, device=dev)
              for dev in grid.ravel()}
    # phase 1 is launched on every shard before any shard's torch.nonzero
    # synchronises, so shards on different cards overlap
    inds = {
        (ji, li, d): _phase1(st.codes[li, d], st.ok[ji][li, d], st.q[ji][li, d],
                             thresh[str(dev)], g)
        for ji in range(len(st.q))
        for (li, d), dev in np.ndenumerate(grid)
    }
    out = [
        _phase2(_compact_pairs(ind), st.codes[li, d], st.ok[ji][li, d], st.q[ji][li, d],
                li, d, st.strands[ji], g, v)
        for (ji, li, d), ind in inds.items()
    ]
    return Hits.concat(out).sorted()


def sharded_scan(
    spacers,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    mesh: Mesh | None = None,
    P: int = 2048,
    sub_width: int = 512,
    site_mode: str = "auto",
) -> Hits:
    """Full multi-shard scan on the dense engine: sharded (strand-fused)
    phase 1, per-shard pair compaction and phase 2, hits gathered on the
    host. Same contract as ``ops.scan.scan_contig``.

    There are no capacities to size: ``torch.nonzero`` compacts the pairs
    and the hits exactly, so no scan overflows or retries."""
    if site_mode not in ("auto", "never", "always"):
        raise ValueError(f"site_mode must be 'auto', 'never' or 'always', got {site_mode!r}")
    mesh = make_mesh() if mesh is None else mesh
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    _check_spacer_len(q_f)
    if site_mode == "always" and pam and q_f.shape[0]:
        raise NotImplementedError(
            "the sharded site engine (site_mode='always') is not ported yet "
            "(ROADMAP module item 4); 'auto' and 'never' give the same Hits"
        )
    g = _geometry(q_f.shape, contig, mesh, P, sub_width)
    if g is None:
        return Hits()
    return _run(_device_state(q_f, contig, pam, pam_direction, mesh, g), g, mesh,
                int(max_mismatches))


def sharded_scan_contigs(
    spacers,
    contigs,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    mesh: Mesh | None = None,
    P: int = 2048,
    sub_width: int = 512,
    site_mode: str = "auto",
) -> list[Hits]:
    """Multi-contig sharded scan, one contig after another on the dense
    engine (the JAX engine's dense form); Hits in INPUT ORDER."""
    mesh = make_mesh() if mesh is None else mesh
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    return [
        sharded_scan(q_f, c, max_mismatches, pam, pam_direction, mesh=mesh, P=P,
                     sub_width=sub_width, site_mode=site_mode)
        for c in contigs
    ]


# --- the older phase-1-only block-max API (the scaling harness's A/B) --------

def _lib_layout(n_lib: int, S_pad: int) -> tuple[int, int, int, int]:
    """Per-library-shard spacer layout for the block-max API: (S_loc, S_tot,
    nsb_local, nsb_pad_local)."""
    S_loc = _cdiv(S_pad, n_lib * BS) * BS
    nsb_local = S_loc // BS
    nsb_pad_local = max(_cdiv(nsb_local, 128) * 128, 128)
    return S_loc, S_loc * n_lib, nsb_local, nsb_pad_local


def sharded_scan_block_max(q_oh: torch.Tensor, scan_codes: np.ndarray, mask: np.ndarray,
                           mesh: Mesh, *, L: int, K: int, P: int):
    """Phase-1 block-max scoring with the genome axis sharded over ``mesh``
    (the previous-generation sharded engine, kept for the scaling A/B).

    q_oh (S_pad, K) bf16 one-hot rows, zero-padded to the library layout
    here (zero rows take part in the max, as in JAX); scan_codes the scan
    array; mask (n_starts,) the allowed starts. Returns (block_max
    (n_tiles_total, 1, n_lib * nsb_pad_local) f32, totals) as numpy, in
    the JAX layout: genome shards along the tile axis, library shards along
    the lanes; totals int32 counts, per lane, of tiles whose block max is
    >= 0, summed over genome shards ((nsb_pad_local,) on a 1-D mesh)."""
    n_lib, n_gen = _mesh_dims(mesh)
    halo = K // 4
    n_starts = len(mask)
    # same boundary-band sizing as sharded_scan
    B = _cdiv(n_starts + halo, n_gen * P) * P
    total = n_gen * B
    codes = np.full(total, 4, dtype=np.int32)
    codes[: min(len(scan_codes), total)] = scan_codes[: min(len(scan_codes), total)]
    allowed = np.zeros(total, dtype=np.int32)
    allowed[:n_starts] = mask[:n_starts]
    bias = np.where(allowed > 0, 0.0, MASK_BIAS).astype(np.float32).reshape(n_gen, B // P, 1, P)

    S_loc, S_tot, _, _ = _lib_layout(n_lib, q_oh.shape[0])
    if S_tot != q_oh.shape[0]:
        q_oh = torch.cat([q_oh, q_oh.new_zeros((S_tot - q_oh.shape[0], q_oh.shape[1]))])
    codes_sh = _codes_to_shards(codes.reshape(n_gen, B), mesh, halo)
    bias_sh = _per_shard(mesh, GENOME_AXIS, lambda d: _from_host(bias[d]))
    q_sh = _per_shard(mesh, LIBRARY_AXIS, lambda li: q_oh[li * S_loc : (li + 1) * S_loc])
    maxes = {}
    for li, d in codes_sh:
        tiles = codes_sh[li, d].unfold(0, P + halo, P)[:, None, :].contiguous()
        maxes[li, d] = scan_block_max(q_sh[li, d], tiles, bias_sh[li, d], L=L, K=K, P=P)
    block_max = np.stack([
        np.concatenate([maxes[li, d].cpu().numpy() for li in range(n_lib)], axis=-1)
        for d in range(n_gen)
    ])
    totals = [
        sum((maxes[li, d] >= 0).sum(dim=(0, 1)).to(torch.int32).cpu().numpy()
            for d in range(n_gen)).astype(np.int32)
        for li in range(n_lib)
    ]
    return block_max.reshape(-1, 1, block_max.shape[-1]), np.concatenate(totals)
