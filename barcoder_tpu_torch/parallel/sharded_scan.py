"""Sharded scan over a 1-D or 2-D mesh: the port of
``barcoder_tpu/parallel/sharded_scan.py`` — the site-compacted engine that
every PAM scan with an informative base takes (``sharded_scan``,
``sharded_scan_many``, ``sharded_scan_contigs``), the dense engine, and the
older block-max API (``sharded_scan_block_max``).

Site engine (``_SiteScanRun``), as in the JAX package: the contig's
PAM-valid windows (``ops.prep.enumerate_sites``, R-strand windows
revcomped) form an (L_pad, n_sites) int8 site-code matrix whose SITE axis
is split over the genome axis, Bs = ceil(n_sites / (n_gen * P)) * P columns
per shard. Columns are independent windows, so there is no halo; a hit's
global column is d * Bs + t * P2 + lane. Phase 1 per shard is the
hit-indicator kernel in its ``matrix_rows`` mode (forward rows only, no
bias), launched on every shard before any ``torch.nonzero`` syncs; phase 2
re-scores each shard's pairs on its site subtiles. On a 2-D mesh the
library axis is split too. ``sharded_scan_many`` serves many libraries
against one genome with ``max_pending`` scans in flight.

Dense engine design, as in the JAX package:

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
    its own device (``ops.scan_hits.phase2_hits``, the CUDA kernel on a
    card) and decodes global positions as ``d * B + column``.

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
  - over a mesh that spans processes (``parallel.multihost``), each process
    builds, ships and launches only the shards it owns (``Mesh.is_local``),
    the library axis of a 2-D mesh crossing the process boundary too, and
    the hit lists of a scan are all-gathered on the host once, at its
    collect, so every process returns the same global Hits. Nothing else
    is exchanged: each shard's halo is read from the host's whole genome,
    as on one process. ``sharded_scan_many`` and ``sharded_scan_contigs``
    collect in input order on every process, so their gathers pair up;
  - ``sharded_scan_block_max`` stays on one process, as in the JAX package,
    which places its inputs with ``jax.device_put`` and so never spans
    hosts there; it refuses a mesh that spans processes.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..core.genome import Contig
from ..ops.cuda_scan import (
    _compact_pairs, _content_digest, _tiles_device_impl, load_sites, onehot_rows,
    site_artifact_key, site_indicator,
)
from ..ops.prep import build_scan_array, revcomp_matrix, site_masks, spacer_matrix
from ..ops.scan_hits import BS, _cdiv, bias_row, k_eff, phase2_hits, q_chunks, scan_block_hits
from ..ops.scan_max import scan_block_max
from ..ops.types import STRAND_F, STRAND_R, Hits
from . import multihost
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


def _local_shards(mesh: Mesh):
    """((library shard, genome shard), device) of every shard this process
    owns, in mesh order."""
    procs = mesh.processes.reshape(_mesh_dims(mesh))
    me = multihost.process_index()
    return [(idx, dev) for idx, dev in np.ndenumerate(_grid(mesh)) if procs[idx] == me]


def _gather_hits(local: Hits, mesh: Mesh) -> Hits:
    """The global Hits of a scan, sorted, from each process's own shards'
    Hits: an all-gather on the host when ``mesh`` spans processes (every
    process calls it once per scan, in the same order), else ``local``."""
    if not mesh.spans_processes():
        return local.sorted()
    cols = np.stack([local.spacer_idx.astype(np.int64), local.pos.astype(np.int64),
                     local.strand.astype(np.int64), local.mismatches.astype(np.int64)])
    parts = [np.frombuffer(blob, np.int64).reshape(4, -1)
             for blob in multihost.allgather_bytes(cols.tobytes())]
    allc = np.concatenate(parts, axis=1)
    return Hits(spacer_idx=allc[0], pos=allc[1], strand=allc[2].astype(np.int8),
                mismatches=allc[3].astype(np.int32)).sorted()


def _check_spacer_len(q_f: np.ndarray) -> None:
    """The JAX engine packs mismatch counts into 6 bits and refuses spacers
    past 63 nt; the port keeps that contract on every entry path."""
    if q_f.shape[0] and q_f.shape[1] > _MAX_SPACER_LEN:
        raise ValueError(
            f"sharded engine supports spacers up to {_MAX_SPACER_LEN} nt "
            f"(got {q_f.shape[1]})"
        )


def _want_sites(pam: str, site_mode: str) -> bool:
    """Engine choice for a PAM scan: site-compacted unless the PAM has no
    informative (non-N) base, where every window-valid position would be a
    site and the site matrix would cost ~L_pad bytes per genome base for no
    saving. "always" still forces sites; "never" forbids them."""
    if site_mode not in ("auto", "never", "always"):
        raise ValueError(f"site_mode must be 'auto', 'never' or 'always', got {site_mode!r}")
    if not pam or site_mode == "never":
        return False
    return site_mode == "always" or any(ch != "N" for ch in pam)


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
    such dict per strand job, and qc each q in the int8 kernels' layout
    (:func:`_chunks_to_shards`; empty until :func:`_run` knows the
    geometry). Shards on one device share their tensors."""

    codes: dict
    ok: list
    q: list
    qc: list
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
    q_f = _spacer_codes(spacers)
    g = _geometry(q_f.shape, contig, mesh, P, sub_width)
    if g is None:
        return None
    return ShardState(codes=_codes_blocks(contig, g), ok=_ok_blocks(contig, pam, pam_direction, g),
                      q=_q_onehots(q_f, g), strands=_strands(g))


def _per_shard(mesh: Mesh, axis: str, make) -> dict:
    """{(li, d): make(i) on the shard's device} for this process's shards,
    with i the shard's index on ``axis``; one tensor per (device, i),
    shared by the shards that repeat a device."""
    made, out = {}, {}
    for (li, d), dev in _local_shards(mesh):
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


def _chunks_to_shards(q: dict, n_sblocks: int, BS_M: int, K_eff: int) -> dict:
    """Each shard's q in the int8 kernels' layout (``scan_hits.q_chunks``),
    built once and read by phase 1 and phase 2 alike. Shards that share a q
    share its chunks."""
    made, out = {}, {}
    for key, t in q.items():
        if id(t) not in made:
            made[id(t)] = q_chunks(t, n_sblocks, BS_M, K_eff)
        out[key] = made[id(t)]
    return out


def _q_with_chunks(qs: list, g: _Geom) -> tuple:
    """(qs, their :func:`_chunks_to_shards`) at the dense phase 1's depth."""
    K_eff = k_eff(g.L, g.R, g.fold)
    return qs, [_chunks_to_shards(q, g.n_sblocks_loc, g.BS_M, K_eff) for q in qs]


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
        qc=[],  # the state carries no geometry: _run lays q out
        strands=list(state.strands),
    )


# --- content-keyed device caches ---------------------------------------------

def _nbytes(v) -> int:
    seen, total = set(), 0
    stack = [v]
    while stack:
        x = stack.pop()
        if isinstance(x, (torch.Tensor, np.ndarray)):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.nbytes if isinstance(x, np.ndarray) else x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


class _ShardCache(OrderedDict):
    """LRU of per-shard device tensors keyed by content digest, geometry and
    the mesh's device list: a repeat scan of one genome and library over
    one mesh builds and ships nothing. Bounded by entries and by bytes, so
    a few large libraries cannot pin device memory. ``stats()`` reports
    hits, misses, evictions and the bytes built on misses: a warm serving
    pass over a working set that fits shows no misses and no bytes."""

    def __init__(self, max_entries: int = 8, max_bytes: int = 1 << 30):
        super().__init__()
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.nbytes: dict = {}
        self.reset_stats()

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "bytes_built": self.bytes_built, "entries": len(self),
                "bytes_resident": sum(self.nbytes.values())}

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = self.bytes_built = 0

    def clear(self) -> None:
        """Drop every entry, its byte count and the counters."""
        super().clear()
        self.nbytes.clear()
        self.reset_stats()

    def get_or_put(self, key, build):
        if key in self:
            self.move_to_end(key)
            self.hits += 1
            return self[key]
        value = build()
        self.misses += 1
        self[key] = value
        self.nbytes[key] = _nbytes(value)
        self.bytes_built += self.nbytes[key]
        while len(self) > 1 and (len(self) > self.max_entries
                                 or sum(self.nbytes.values()) > self.max_bytes):
            old, _ = self.popitem(last=False)
            self.nbytes.pop(old)
            self.evictions += 1
        return value


_GENOME_SHARD_CACHE = _ShardCache()
# sized for a serving set of libraries, not just one
_Q_SHARD_CACHE = _ShardCache(max_entries=32)
# host-memory site tables (numpy, backed by the on-disk artifact store),
# kept out of the device caches so a large host table and its device codes
# do not evict each other
_SITE_HOST_CACHE = _ShardCache(max_entries=6, max_bytes=3 << 30)


def serving_cache_stats(reset: bool = False) -> dict:
    """Hit / miss / eviction / bytes counters of the genome-side, the
    library-side and the host site-table caches; ``reset=True`` zeroes them
    after reading."""
    caches = {"genome": _GENOME_SHARD_CACHE, "q": _Q_SHARD_CACHE,
              "site_host": _SITE_HOST_CACHE}
    out = {name: c.stats() for name, c in caches.items()}
    if reset:
        for c in caches.values():
            c.reset_stats()
    return out


def _mesh_key(mesh: Mesh) -> tuple:
    return (tuple(mesh.shape.items()), tuple(str(d) for d in mesh.devices.ravel()),
            tuple(mesh.processes.ravel().tolist()))


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
    q, qc = _Q_SHARD_CACHE.get_or_put(
        ("q", _content_digest(q_f), q_f.shape, g.S_loc, g.n_lib, mkey),
        lambda: _q_with_chunks([_q_to_shards(a, mesh) for a in _q_onehots(q_f, g)], g))
    return ShardTensors(codes=codes, ok=ok, q=q, qc=qc, strands=_strands(g))


# --- the dense engine --------------------------------------------------------

def _phase1(codes, ok, q, thresh, g: _Geom, qc=None):
    """One shard's phase 1: its tiles and bias built on its device, then the
    hit-indicator kernel (plain torch on the CPU), reading ``qc`` where it
    is given (:func:`_chunks_to_shards`)."""
    tiles = _tiles_device_impl(codes, n_starts=g.B, P=g.P, halo=g.halo)
    bias = bias_row(ok > 0)
    bias = bias.reshape(g.R, g.B // g.P, g.P).transpose(0, 1).contiguous()
    return scan_block_hits(thresh, q, tiles, bias, L=g.L, K=g.K, P=g.P, SUB=g.SUB,
                           BS_M=g.BS_M, fold_bias=g.fold, qc=qc)


def _phase2(pairs, codes, ok, qc, li: int, d: int, strand, g: _Geom, v: int) -> Hits:
    """One shard's phase 2: re-score its pairs in one call of the phase-2
    kernel on the chunks ``qc`` phase 1 read, and decode the hits to global
    (spacer, position)."""
    if len(pairs) == 0:
        return Hits()
    n_sb = g.n_sblocks_loc
    rec = phase2_hits(
        qc, codes, pairs, mask=ok,
        half_blocks=g.half_blocks if g.fused else n_sb, n_sb_pad8=_cdiv(n_sb, 8) * 8,
        SUB=g.SUB, L=g.L, v=v, BS_M=g.BS_M, P2=g.P2, S=g.S_loc, n_sub=g.B // g.P2,
        code_stride=1,
    ).cpu().numpy()
    spacer = li * g.S_loc + rec[:, 0].astype(np.int64)
    pos = d * g.B + rec[:, 1].astype(np.int64)
    keep = (spacer < g.S) & (pos < g.n_starts)
    rev = rec[keep, 2] != 0
    return Hits(spacer_idx=spacer[keep], pos=pos[keep],
                strand=(np.where(rev, STRAND_R, STRAND_F) if strand is None
                        else np.full(len(rev), strand)).astype(np.int8),
                mismatches=rec[keep, 3])


def _thresholds(shards, value: float) -> dict:
    """{device name: the threshold as a one-element f32 tensor there}."""
    return {str(dev): torch.full((1,), value, dtype=torch.float32, device=dev)
            for _, dev in shards}


def _run(st: ShardTensors, g: _Geom, mesh: Mesh, v: int) -> Hits:
    shards = _local_shards(mesh)
    thresh = _thresholds(shards, float(g.L - v))
    qc = st.qc or _q_with_chunks(st.q, g)[1]
    # phase 1 is launched on every shard before any shard's torch.nonzero
    # synchronises, so shards on different cards overlap
    inds = {
        (ji, li, d): _phase1(st.codes[li, d], st.ok[ji][li, d], st.q[ji][li, d],
                             thresh[str(dev)], g, qc[ji][li, d])
        for ji in range(len(st.q))
        for (li, d), dev in shards
    }
    out = [
        _phase2(_compact_pairs(ind), st.codes[li, d], st.ok[ji][li, d], qc[ji][li, d], li, d,
                st.strands[ji], g, v)
        for (ji, li, d), ind in inds.items()
    ]
    return _gather_hits(Hits.concat(out), mesh)


# --- the site-compacted engine -----------------------------------------------

def _site_table_host(contig: Contig, L: int, pam: str, pam_direction: str):
    """((positions, strands, codes), digest) for one contig: from this
    process's host cache, else the on-disk artifact the one-card engine
    shares, else enumerated (and stored)."""
    digest = _content_digest(contig.codes)
    art_key = site_artifact_key(digest, contig, L, pam, pam_direction)
    table = _SITE_HOST_CACHE.get_or_put(
        ("site_host", art_key), lambda: load_sites(art_key, contig, L, pam, pam_direction))
    return table, digest


class _SiteScanRun:
    """One site-compacted sharded scan, split into dispatch (construction:
    the shard state from the caches and phase 1 launched on every shard)
    and collect (compaction, phase 2 and the decode), so that many scans
    can have their device work queued before any result is read."""

    def __init__(self, q_f: np.ndarray, contig: Contig, max_mismatches: int, pam: str,
                 pam_direction: str, mesh: Mesh, P: int, sub_width: int):
        _check_spacer_len(q_f)
        n_lib, n_gen = _mesh_dims(mesh)
        S, L = q_f.shape
        (positions, strands, codes), digest = _site_table_host(contig, L, pam, pam_direction)
        n_sites = len(positions)
        self.empty = n_sites == 0 or S == 0
        if self.empty:
            return
        K = max(_cdiv(4 * L, 128) * 128, 128)
        SUB, P2 = _phase2_geom(P, sub_width)
        BS_M = 512 if S >= 2048 else (256 if S >= 512 else BS)
        L_pad = _cdiv(L, 8) * 8
        Bs = _cdiv(n_sites, n_gen * P) * P
        S_loc = _cdiv(S, n_lib * BS_M) * BS_M
        mkey = _mesh_key(mesh)

        def codes_to_shards():
            codes_lp = np.full((L_pad, n_gen * Bs), 4, dtype=np.int8)
            codes_lp[:L, :n_sites] = codes.T
            return _per_shard(mesh, GENOME_AXIS,
                              lambda d: _from_host(codes_lp[:, d * Bs : (d + 1) * Bs]))

        self.codes = _GENOME_SHARD_CACHE.get_or_put(
            ("site_codes", digest, contig.id, contig.length, bool(contig.circular), L, pam,
             pam_direction, n_gen, Bs, mkey), codes_to_shards)
        q_pad = np.full((n_lib * S_loc, L), 4, dtype=np.int8)
        q_pad[:S] = q_f
        # forward rows only; the constant-1 column of a foldable L meets
        # zero G rows in matrix mode, so the chunks stop at the site depth
        def q_to_shards():
            q = _q_to_shards(_host_onehot(q_pad, K, L, 4 * L < K, 0), mesh)
            return q, _chunks_to_shards(q, S_loc // BS_M, BS_M, k_eff(L, 1, False))

        self.q, self.qc = _Q_SHARD_CACHE.get_or_put(
            (_content_digest(q_pad), "site", K, n_lib, S_loc, mkey), q_to_shards)
        self.mesh, self.positions, self.strands = mesh, positions, strands
        self.S, self.L, self.SUB, self.P2 = S, L, SUB, P2
        self.BS_M, self.Bs, self.S_loc, self.n_sites = BS_M, Bs, S_loc, n_sites
        self.v = int(max_mismatches)
        shards = _local_shards(mesh)
        thresh = _thresholds(shards, float(L - self.v))
        # phase 1 on every shard before any shard's torch.nonzero syncs
        self.inds = {
            (li, d): site_indicator(self.codes[li, d], self.q[li, d], thresh[str(dev)], P=P,
                                    L=L, K=K, SUB=SUB, BS_M=BS_M, qc=self.qc[li, d])
            for (li, d), dev in shards
        }

    def _phase2(self, pairs, li: int, d: int) -> Hits:
        """One shard's phase 2, in one call of the phase-2 kernel, decoded
        to global spacer indices and site columns."""
        if len(pairs) == 0:
            return Hits()
        n_sb = self.S_loc // self.BS_M
        rec = phase2_hits(
            self.qc[li, d], self.codes[li, d], pairs, half_blocks=n_sb,
            n_sb_pad8=_cdiv(n_sb, 8) * 8, SUB=self.SUB, L=self.L, v=self.v, BS_M=self.BS_M,
            P2=self.P2, S=self.S_loc, n_sub=self.Bs // self.P2, code_stride=self.Bs,
            n_valid=self.n_sites - d * self.Bs,
        ).cpu().numpy()
        spacer = li * self.S_loc + rec[:, 0].astype(np.int64)
        keep = spacer < self.S
        site = d * self.Bs + rec[keep, 1]
        return Hits(spacer_idx=spacer[keep], pos=self.positions[site].astype(np.int64),
                    strand=self.strands[site].astype(np.int8), mismatches=rec[keep, 3])

    def collect(self) -> Hits:
        # an empty scan is empty on every process (the site table and the
        # library are the same everywhere), so none of them gathers
        if self.empty:
            return Hits()
        return _gather_hits(Hits.concat([self._phase2(_compact_pairs(ind), li, d)
                                         for (li, d), ind in self.inds.items()]), self.mesh)


def _windowed_collect(makers, max_pending: int) -> list:
    """Run dispatch/collect jobs with at most ``max_pending`` in flight: the
    oldest job is collected before the next is constructed (construction
    dispatches). Results in input order."""
    results: list = [None] * len(makers)
    pending: list = []
    for i, make in enumerate(makers):
        if len(pending) >= max_pending:
            j, run = pending.pop(0)
            results[j] = run.collect()
        pending.append((i, make()))
    for j, run in pending:
        results[j] = run.collect()
    return results


def _spacer_codes(spacers) -> np.ndarray:
    return spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers


# --- entry points ------------------------------------------------------------

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
    """Full multi-shard scan, hits gathered on the host; same contract as
    ``ops.scan.scan_contig``. A PAM scan with an informative base takes the
    site-compacted engine (``_want_sites``; "never" forces the dense one,
    "always" forces sites); the dense engine runs the strand-fused phase 1,
    per-shard pair compaction and phase 2.

    There are no capacities to size: ``torch.nonzero`` compacts the pairs
    and the hits exactly, so no scan overflows or retries."""
    mesh = make_mesh() if mesh is None else mesh
    q_f = _spacer_codes(spacers)
    _check_spacer_len(q_f)
    if _want_sites(pam, site_mode) and q_f.shape[0]:
        return _SiteScanRun(q_f, contig, max_mismatches, pam, pam_direction, mesh, P,
                            sub_width).collect()
    g = _geometry(q_f.shape, contig, mesh, P, sub_width)
    if g is None:
        return Hits()
    return _run(_device_state(q_f, contig, pam, pam_direction, mesh, g), g, mesh,
                int(max_mismatches))


def sharded_scan_many(
    libraries,
    contig: Contig,
    max_mismatches: int,
    pam: str,
    pam_direction: str = "downstream",
    mesh: Mesh | None = None,
    P: int = 2048,
    sub_width: int = 512,
    max_pending: int = 4,
) -> list[Hits]:
    """Serving: scan many libraries against one contig on the site engine,
    each library's phase 1 launched before the results of up to
    ``max_pending`` earlier libraries are read. Requires a PAM. Hits in
    input order."""
    if not pam:
        raise ValueError("sharded_scan_many serves PAM site-compacted scans")
    mesh = make_mesh() if mesh is None else mesh
    makers = [
        lambda sp=sp: _SiteScanRun(_spacer_codes(sp), contig, max_mismatches, pam,
                                   pam_direction, mesh, P, sub_width)
        for sp in libraries
    ]
    return _windowed_collect(makers, max_pending)


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
    max_pending: int = 4,
) -> list[Hits]:
    """Multi-contig sharded scan; Hits in INPUT ORDER. Site scans are
    windowed like ``sharded_scan_many`` (each contig's phase 1 launched
    ahead of earlier contigs' collects); dense scans run one contig after
    another."""
    mesh = make_mesh() if mesh is None else mesh
    q_f = _spacer_codes(spacers)
    if not (q_f.shape[0] and _want_sites(pam, site_mode)):
        return [
            sharded_scan(q_f, c, max_mismatches, pam, pam_direction, mesh=mesh, P=P,
                         sub_width=sub_width, site_mode=site_mode)
            for c in contigs
        ]
    makers = [
        lambda c=c: _SiteScanRun(q_f, c, max_mismatches, pam, pam_direction, mesh, P,
                                 sub_width)
        for c in contigs
    ]
    return _windowed_collect(makers, max_pending)


# --- the older phase-1-only block-max API (the scaling harness's A/B) --------

def _lib_layout(n_lib: int, S_pad: int) -> tuple[int, int, int, int]:
    """Per-library-shard spacer layout for the block-max API: (S_loc, S_tot,
    nsb_local, nsb_pad_local)."""
    S_loc = _cdiv(S_pad, n_lib * BS) * BS
    nsb_local = S_loc // BS
    nsb_pad_local = max(_cdiv(nsb_local, 128) * 128, 128)
    return S_loc, S_loc * n_lib, nsb_local, nsb_pad_local


def _block_max_state(scan_codes: np.ndarray, mask: np.ndarray, mesh: Mesh, *, K: int, P: int):
    """The block-max API's genome side per shard, from the genome cache:
    ({(li, d): tiles (B / P, 1, P + halo) int32}, {(li, d): bias (B / P, 1,
    P) f32}), keyed by the content of ``scan_codes`` and ``mask``, the
    geometry and the mesh. On a miss the padded codes (with each shard's
    ring halo) and the int8 allowed mask are built on the host and shipped,
    and the bias is made on the device from the mask. The digests are
    memoized for read-only arrays (``_content_digest``): freeze the arrays
    and a repeat call hashes nothing."""
    n_gen = _mesh_dims(mesh)[1]
    halo = K // 4
    n_starts = len(mask)
    # same boundary-band sizing as sharded_scan
    B = _cdiv(n_starts + halo, n_gen * P) * P

    def build():
        total = n_gen * B
        codes = np.full(total, 4, dtype=np.int32)
        codes[: min(len(scan_codes), total)] = scan_codes[: min(len(scan_codes), total)]
        allowed = np.zeros(total, dtype=np.int8)
        allowed[:n_starts] = mask[:n_starts] > 0
        codes_sh = _codes_to_shards(codes.reshape(n_gen, B), mesh, halo)
        allowed_sh = _per_shard(mesh, GENOME_AXIS,
                                lambda d: _from_host(allowed[d * B : (d + 1) * B]))
        # one tensor per (device, genome shard), shared by its library shards
        tiles = {id(c): c.unfold(0, P + halo, P)[:, None, :].contiguous()
                 for c in codes_sh.values()}
        bias = {id(a): bias_row(a > 0).reshape(B // P, 1, P) for a in allowed_sh.values()}
        return ({k: tiles[id(c)] for k, c in codes_sh.items()},
                {k: bias[id(a)] for k, a in allowed_sh.items()})

    return _GENOME_SHARD_CACHE.get_or_put(
        ("block_max", _content_digest(scan_codes), _content_digest(mask), n_starts, P, K,
         _mesh_key(mesh)), build)


def sharded_scan_block_max(q_oh: torch.Tensor, scan_codes: np.ndarray, mask: np.ndarray,
                           mesh: Mesh, *, L: int, K: int, P: int):
    """Phase-1 block-max scoring with the genome axis sharded over ``mesh``
    (the previous-generation sharded engine, kept for the scaling A/B).

    q_oh (S_pad, K) bf16 one-hot rows, zero-padded to the library layout
    here (zero rows take part in the max, as in JAX); scan_codes the scan
    array; mask (n_starts,) the allowed starts. The per-shard tiles and
    bias live in the genome cache (:func:`_block_max_state`,
    ``serving_cache_stats``), so a repeat call on the same arrays builds and
    ships nothing. Returns (block_max
    (n_tiles_total, 1, n_lib * nsb_pad_local) f32, totals) as numpy, in
    the JAX layout: genome shards along the tile axis, library shards along
    the lanes; totals int32 counts, per lane, of tiles whose block max is
    >= 0, summed over genome shards ((nsb_pad_local,) on a 1-D mesh)."""
    if mesh.spans_processes():
        raise ValueError("sharded_scan_block_max runs on one process; its mesh spans several")
    n_lib, n_gen = _mesh_dims(mesh)
    tiles_sh, bias_sh = _block_max_state(scan_codes, mask, mesh, K=K, P=P)
    S_loc, S_tot, _, _ = _lib_layout(n_lib, q_oh.shape[0])
    if S_tot != q_oh.shape[0]:
        q_oh = torch.cat([q_oh, q_oh.new_zeros((S_tot - q_oh.shape[0], q_oh.shape[1]))])
    q_sh = _per_shard(mesh, LIBRARY_AXIS, lambda li: q_oh[li * S_loc : (li + 1) * S_loc])
    maxes = {
        (li, d): scan_block_max(q_sh[li, d], tiles_sh[li, d], bias_sh[li, d], L=L, K=K, P=P)
        for li, d in tiles_sh
    }
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
