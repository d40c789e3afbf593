"""The port's counting workload (``barcoder_tpu_torch.pipeline.heuristic_count``,
a partial copy of the JAX package's, with ``CudaCounter`` in place of
``DeviceCounter``, and its ``count`` CLI) held against the JAX package's on
the simulated read sets of tests/test_heuristic_count.py.

Every comparison is EXACT: the port's ``vector``, ``device`` (its matching
run with ``device="cpu"``) and ``reference`` engines must give the same
``(doc, undoc, total_reads)`` as the JAX package's ``vector`` and ``device``
engines on the same files. The card's own run of ``CudaCounter`` is in
tests/test_torch_gpu.py.
"""

import os
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import barcoder_tpu.pipeline.heuristic_count as jhc
import barcoder_tpu_torch.pipeline.heuristic_count as thc
from barcoder_tpu.cli.count import main as ref_cli
from barcoder_tpu_torch.cli.count import main as port_cli
from barcoder_tpu_torch.parallel.sharded_count import make_read_mesh

from .genomes import random_seq
from .test_heuristic_count import (
    L_FLANK, PREFIX, R_FLANK, make_barcodes, make_reads, paired_cfg, write_reads,
)

torch.set_num_threads(1)

# (name, package, engine, extra keywords)
ENGINES = [
    ("jax_vector", jhc, "vector", {}),
    ("jax_device", jhc, "device", {}),
    ("vector", thc, "vector", {}),
    ("device", thc, "device", {"device": "cpu"}),
    ("sharded", thc, "sharded", {"mesh": make_read_mesh(devices=[torch.device("cpu")] * 3)}),
    ("reference", thc, "reference", {}),
]


def count_all(barcodes, f1, f2=None, **kw):
    """(doc, undoc, total) of every engine of both packages; asserts they
    are all equal and returns the port device engine's with its info."""
    results, infos = {}, {}
    for name, mod, engine, extra in ENGINES:
        doc, undoc, total, info = mod.run_count(set(barcodes), f1, f2, engine=engine,
                                                **extra, **kw)
        results[name] = (doc, undoc, total)
        infos[name] = info
    for name, got in results.items():
        assert got == results["jax_vector"], name
    return results["device"], infos["device"]


def _files(tmp_path, reads1, reads2=None):
    f1 = tmp_path / "r1.fastq"
    write_reads(f1, reads1)
    if reads2 is None:
        return str(f1), None
    f2 = tmp_path / "r2.fastq"
    write_reads(f2, reads2)
    return str(f1), str(f2)


def _case(name):
    """Barcodes, read files' contents and the truth of each agreement case
    (the data shapes of TestDeviceEngine, TestBarcodeLengthBoundaries and
    the N-in-core case of tests/test_heuristic_count.py, and more)."""
    if name == "n_in_core":
        barcodes = make_barcodes(n=20, seed=17)
        reads1, _, _ = make_reads(barcodes, n_reads=2000, seed=17)
        start = len(PREFIX) + len(L_FLANK)
        for i in range(300):  # an N inside the barcode slot
            r = reads1[i]
            reads1[i] = r[: start + 7] + "N" + r[start + 8 :]
        return barcodes, reads1, None, None
    if name == "len32_high_keys":
        # 32-nt barcodes whose last base is G or T set bit 63 of their key:
        # negative as int64, so the card's signed sort must still find them
        rng = np.random.default_rng(23)
        barcodes = sorted({random_seq(31, rng) + "ACGT"[i % 4] for i in range(16)})
        reads1, reads2, truth = make_reads(barcodes, n_reads=1500, seed=23)
        keys = thc._pack_strings(barcodes)
        assert (keys >= np.uint64(1 << 63)).any() and (keys < np.uint64(1 << 63)).any()
        return barcodes, reads1, reads2, truth
    spec = {
        "single": dict(seed=3, paired=False),
        "paired": dict(seed=3, paired=True),
        "undocumented": dict(seed=3, paired=False, undoc=2),
        "paired_undocumented_n": dict(seed=5, paired=True, undoc=1, n_frac=0.03),
        "random_tail": dict(seed=6, paired=True, random_tail=True),
        "len32": dict(seed=21, paired=True, bc_len=32, n=12, n_reads=1500),
    }[name]
    barcodes = make_barcodes(n=spec.get("n", 25), bc_len=spec.get("bc_len", 20),
                             seed=spec["seed"])
    undoc = [random_seq(spec.get("bc_len", 20), np.random.default_rng(99))
             for _ in range(spec.get("undoc", 0))]
    reads1, reads2, truth = make_reads(
        barcodes, n_reads=spec.get("n_reads", 3000), seed=spec["seed"], undocumented=undoc,
        n_frac=spec.get("n_frac", 0.0), random_tail=spec.get("random_tail", False))
    return barcodes, reads1, reads2 if spec["paired"] else None, (
        None if undoc or spec.get("n_frac") else truth)


AGREEMENT_CASES = ["single", "paired", "undocumented", "paired_undocumented_n",
                   "random_tail", "n_in_core", "len32", "len32_high_keys"]


@pytest.mark.parametrize("name", AGREEMENT_CASES)
def test_engines_agree_with_the_jax_package(tmp_path, name):
    barcodes, reads1, reads2, truth = _case(name)
    (doc, undoc, total), info = count_all(barcodes, *_files(tmp_path, reads1, reads2),
                                          chunk_size=512)
    assert info["engine"] == "device"
    assert total == len(reads1)
    if truth is not None:
        assert doc == truth
    if name == "undocumented":
        assert sum(undoc.values()) > 0 and all(k.endswith("*") for k in undoc)
    if name == "n_in_core":
        assert sum(doc.values()) + sum(undoc.values()) == 2000 - 300


def test_swapped_files_agree(tmp_path):
    """Mates given in the other order: the discovered config swaps them."""
    barcodes = make_barcodes(n=15, seed=12)
    reads1, reads2, truth = make_reads(barcodes, n_reads=1500, seed=12)
    (doc, _, _), info = count_all(barcodes, *_files(tmp_path, reads2, reads1))
    assert info["config"].need_swap
    assert doc == truth


class _Log:
    def __init__(self):
        self.warnings = []

    def info(self, *a):
        pass

    def warn(self, msg):
        self.warnings.append(msg)


@pytest.mark.parametrize("engine", ["auto", "vector"])
def test_len40_falls_back_to_the_per_read_engine(tmp_path, engine):
    """Over 32 nt only the per-read engine can count, as in the JAX package;
    the port says so in the log for ``auto`` too."""
    barcodes = make_barcodes(n=12, bc_len=40, seed=22)
    reads1, _, truth = make_reads(barcodes, n_reads=800, seed=22)
    f1, _ = _files(tmp_path, reads1)
    log = _Log()
    got = thc.run_count(set(barcodes), f1, engine=engine, log=log)
    want = jhc.run_count(set(barcodes), f1, engine=engine)
    assert got[3]["engine"] == want[3]["engine"] == "reference"
    assert got[:3] == want[:3]
    assert got[0] == truth
    assert any("40" in w for w in log.warnings)


def test_len40_device_engine_raises(tmp_path):
    """``engine="device"`` (and ``"sharded"``) never counts on the host:
    over 32 nt it raises where the JAX package falls back to the per-read
    engine."""
    barcodes = make_barcodes(n=12, bc_len=40, seed=22)
    reads1, _, _ = make_reads(barcodes, n_reads=200, seed=22)
    f1, _ = _files(tmp_path, reads1)
    with pytest.raises(ValueError, match="<= 32 nt"):
        thc.run_count(set(barcodes), f1, engine="device", device="cpu")
    with pytest.raises(ValueError, match="sharded engine requires barcodes <= 32 nt"):
        thc.run_count(set(barcodes), f1, engine="sharded",
                      mesh=make_read_mesh(devices=[torch.device("cpu")] * 2))


def test_auto_is_the_device_engine(tmp_path, monkeypatch):
    """``auto`` is ``CudaCounter``: on the card by default, so it raises
    without CUDA; with ``device="cpu"`` it matches on the CPU and reports
    the device engine, with the JAX package's counts."""
    barcodes = make_barcodes(n=12, seed=14)
    reads1, reads2, truth = make_reads(barcodes, n_reads=1200, seed=14)
    f1, f2 = _files(tmp_path, reads1, reads2)
    got = thc.run_count(set(barcodes), f1, f2, device="cpu")
    assert got[3]["engine"] == "device"
    assert got[:3] == jhc.run_count(set(barcodes), f1, f2)[:3]
    assert got[0] == truth
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        thc.run_count(set(barcodes), f1, f2)


def test_auto_counts_a_library_with_an_n_on_the_host(tmp_path):
    """A barcode with an N has no 2-bit key, so the card engine refuses the
    library; ``auto`` counts it on the host and says so in the log."""
    barcodes = make_barcodes(n=12, seed=15)
    reads1, _, truth = make_reads(barcodes, n_reads=900, seed=15)
    f1, _ = _files(tmp_path, reads1)
    library = set(barcodes) | {"ACGTN" * 4}
    log = _Log()
    got = thc.run_count(library, f1, log=log)
    want = jhc.run_count(library, f1)
    assert got[3]["engine"] == want[3]["engine"] == "vector"
    assert got[:3] == want[:3]
    assert got[0] == truth
    assert any("pure ACGT" in w for w in log.warnings)
    with pytest.raises(ValueError, match="pure-ACGT"):
        thc.run_count(library, f1, engine="device", device="cpu")


def test_sorted_keys_at_and_above_2_63():
    """Keys with bit 63 set sort first as int64: the card's table is in
    signed order, and each key still finds its own library row."""
    barcodes = ["T" * 31 + "G", "G" * 32, "A" * 31 + "T", "C" * 32, "A" * 32,
                "ACGT" * 8, "TGCA" * 8, "GATC" * 8, "CTAG" * 8, "TTGG" * 8]
    cfg = thc.CountConfig(barcodes=set(barcodes), bc_len=32, L_fwd="AA", R_fwd="CC",
                          L_fwd_start=0)
    keys = thc._pack_strings(sorted(barcodes))
    assert (keys >= np.uint64(1 << 63)).sum() >= 4
    cc = thc.CudaCounter(cfg, device="cpu")
    sk = cc._keys_dev.numpy()
    assert (np.diff(sk) > 0).all() and sk[0] < 0
    assert [cc.bc_list[r] for r in cc._rows_dev.tolist()] == [
        cc.bc_list[i] for i in np.argsort(keys.view(np.int64))]
    reads = ["AA" + bc + "CC" for bc in barcodes for _ in range(3)] + ["AA" + "C" * 31 + "A" + "CC"]
    cc.process_chunk((reads, None))
    vc = jhc.VectorCounter(jhc.CountConfig(barcodes=set(barcodes), bc_len=32, L_fwd="AA",
                                           R_fwd="CC", L_fwd_start=0))
    vc.process_chunk((reads, None))
    assert cc.results() == vc.results()
    assert cc.results()[0] == Counter({bc: 3 for bc in barcodes})


def test_all_t_32nt_barcode_counts_as_the_oracle_does():
    """A 32-nt all-T barcode packs to the key ~0, the sentinel of a non-ACGT
    core. The per-read oracle and DeviceCounter count it as documented,
    and so does CudaCounter. (VectorCounter's numpy path files it as
    undocumented: a fault of the JAX package that its byte-equal copy in
    the port keeps.)"""
    barcodes = make_barcodes(n=10, bc_len=32, seed=1) + ["T" * 32]
    spec = dict(barcodes=set(barcodes), bc_len=32, L_fwd="AA", R_fwd="CC", L_rev="GG",
                R_rev="TT", L_fwd_start=0, L_rev_start=0)
    reads1 = ["AA" + b + "CC" for b in barcodes]
    reads2 = ["GG" + thc.rev_comp(b) + "TT" for b in barcodes]
    ref, _ = jhc.count_chunk_reference((reads1, reads2), jhc.CountConfig(**spec))
    jd = jhc.DeviceCounter(jhc.CountConfig(**spec))
    jd.process_chunk((reads1, reads2))
    cc = thc.CudaCounter(thc.CountConfig(**spec), device="cpu")
    cc.process_chunk((reads1, reads2))
    doc, undoc = cc.results()
    assert (doc, undoc) == jd.results() == (ref, Counter())
    assert doc["T" * 32] == 1


@pytest.mark.parametrize("native", [True, False])
def test_lowercase_cores_match_the_jax_package(native):
    """A lowercase core is not its barcode to the per-read oracle, to
    DeviceCounter and to CudaCounter: undocumented. VectorCounter's numpy
    path agrees; its native single-end path counts it as the uppercase
    barcode (a fault of the JAX package). Either way the port's
    VectorCounter gives the JAX package's counts."""
    barcodes = make_barcodes(n=10, seed=2)
    spec = dict(barcodes=set(barcodes), bc_len=20, L_fwd="AA", R_fwd="CC", L_fwd_start=0)
    reads = ["AA" + b + "CC" for b in barcodes] + ["AA" + b.lower() + "CC" for b in barcodes[:4]]
    ref, _ = jhc.count_chunk_reference((reads, None), jhc.CountConfig(**spec))
    want = (Counter({k: v for k, v in ref.items() if not k.endswith("*")}),
            Counter({k: v for k, v in ref.items() if k.endswith("*")}))
    assert sum(want[1].values()) == 4
    jd = jhc.DeviceCounter(jhc.CountConfig(**spec))
    cc = thc.CudaCounter(thc.CountConfig(**spec), device="cpu")
    for counter in (jd, cc):
        counter.process_chunk((reads, None))
    assert cc.results() == jd.results() == want
    vectors = [jhc.VectorCounter(jhc.CountConfig(**spec)),
               thc.VectorCounter(thc.CountConfig(**spec))]
    for vc in vectors:
        if not native:
            vc._try_native_single_end = lambda *a: False
        vc.process_chunk((reads, None))
    assert vectors[0].results() == vectors[1].results()
    if not native:
        assert vectors[1].results() == want


TRUNCATION_CASES = {
    "tail_endswith_flank": (dict(barcodes={"ACGTACGTAC"}, bc_len=10, L_fwd="AA", R_fwd="GG",
                                 L_fwd_start=0),
                            ["AAACGTGG", "AA" + "ACGTACGTAC" + "GG"], None),
    "sentinel_library_barcode": (dict(barcodes={"ACGNACGTAC", "ACGTACGTAC"}, bc_len=10,
                                      L_fwd="AA", R_fwd="", L_fwd_start=0),
                                 ["AAACGTAC", "AAACGTACGTAC"], None),
    "paired_truncated_cores": (dict(barcodes={"GGGGGCCCCC"}, bc_len=10, L_fwd="AA", R_fwd="",
                                    L_rev="TT", R_rev="", L_fwd_start=0, L_rev_start=0),
                               ["AAGGGGG"], ["TTCCC"]),
    "rev_single_end": (dict(barcodes={"ACGTACGTAC"}, bc_len=10, L_rev="TT", R_rev=None,
                            L_rev_start=0),
                       None, ["TTGCAT", "TT" + "GTACGTACGT"]),
}


def _random_truncation():
    rng = np.random.default_rng(77)
    bcs = {random_seq(8, rng) for _ in range(12)}
    reads = []
    for _ in range(300):
        bc = list(bcs)[int(rng.integers(0, len(bcs)))]
        full = "G" + "CA" + bc + "TG" + random_seq(3, rng)
        reads.append(full[: int(rng.integers(3, len(full) + 1))])
    return dict(barcodes=bcs, bc_len=8, L_fwd="CA", R_fwd="TG", L_fwd_start=1), reads, None


TRUNCATION_CASES["random_truncation"] = _random_truncation()


@pytest.mark.parametrize("counter", ["vector", "device"])
@pytest.mark.parametrize("name", sorted(TRUNCATION_CASES))
def test_truncated_windows_match_the_jax_package(name, counter):
    """TestTruncatedReadParity's repros: the port's counters against the
    JAX VectorCounter and the per-read oracle. The device engine refuses a
    library with a non-ACGT barcode, as DeviceCounter does."""
    spec, reads1, reads2 = TRUNCATION_CASES[name]
    ref_counts, _ = jhc.count_chunk_reference((reads1, reads2), jhc.CountConfig(**spec))
    want = jhc.VectorCounter(jhc.CountConfig(**spec))
    want.process_chunk((reads1, reads2))
    cfg = thc.CountConfig(**spec)
    if counter == "device" and name == "sentinel_library_barcode":
        with pytest.raises(ValueError, match="pure-ACGT"):
            thc.CudaCounter(cfg, device="cpu")
        with pytest.raises(ValueError, match="pure-ACGT"):
            jhc.DeviceCounter(jhc.CountConfig(**spec))
        return
    vc = thc.CudaCounter(cfg, device="cpu") if counter == "device" else thc.VectorCounter(cfg)
    vc.process_chunk((reads1, reads2))
    doc, undoc = vc.results()
    assert (doc, undoc) == want.results()
    assert doc == Counter({k: v for k, v in ref_counts.items() if not k.endswith("*")})
    assert undoc == Counter({k: v for k, v in ref_counts.items() if k.endswith("*")})


def test_counter_matches_the_per_read_oracle_chunk_by_chunk():
    """CudaCounter's matrix entry point on the paired geometry of the
    multi-host worker (paired_cfg), fed in several chunks, against
    count_chunk_reference over the whole stream."""
    barcodes = make_barcodes(n=20, seed=31)
    reads1, reads2, truth = make_reads(barcodes, n_reads=2400, seed=31, n_frac=0.02,
                                       undocumented=[random_seq(20, np.random.default_rng(8))])
    cc = thc.CudaCounter(paired_cfg(barcodes), device="cpu")
    cc._DISPATCH_ROWS = 700  # dispatches that straddle the 500-read chunks
    for i in range(0, 2400, 500):
        cc.process_chunk((reads1[i : i + 500], reads2[i : i + 500]))
    ref, n = thc.count_chunk_reference((reads1, reads2), paired_cfg(barcodes))
    doc, undoc = cc.results()
    assert cc.total_reads == n == 2400
    assert doc == Counter({k: v for k, v in ref.items() if not k.endswith("*")})
    assert undoc == Counter({k: v for k, v in ref.items() if k.endswith("*")})
    assert sum(undoc.values()) > 0


def test_worker_tallies_undocumented_apart_until_drain(monkeypatch):
    """Batches the worker retires itself (more than _MAX_PENDING in flight)
    tally their unmatched cores apart from ``undoc``, which the caller's
    thread alone writes; drain() merges them, and the counts are exact."""
    monkeypatch.setattr(thc.CudaCounter, "_MAX_PENDING", 1)
    monkeypatch.setattr(thc.CudaCounter, "_DISPATCH_ROWS", 300)
    barcodes = make_barcodes(n=20, seed=32)
    reads1, reads2, _ = make_reads(barcodes, n_reads=2400, seed=32,
                                   undocumented=[random_seq(20, np.random.default_rng(9))])
    cc = thc.CudaCounter(paired_cfg(barcodes), device="cpu")
    for i in range(0, 2400, 300):
        cc.process_chunk((reads1[i : i + 300], reads2[i : i + 300]))
    cc._work_q.join()  # every batch handed over; 7 of 8 retired by the worker
    assert cc.undoc == Counter() and sum(cc._spilled_undoc.values()) > 0
    ref, _ = thc.count_chunk_reference((reads1, reads2), paired_cfg(barcodes))
    assert cc.results() == (Counter({k: v for k, v in ref.items() if not k.endswith("*")}),
                            Counter({k: v for k, v in ref.items() if k.endswith("*")}))
    assert cc._spilled_undoc == Counter()


# --- checkpoints (tests/test_checkpoint.py) ------------------------------------

@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_reads")
    barcodes = make_barcodes(n=15)
    reads1, reads2, _ = make_reads(barcodes, n_reads=3000)
    f1, f2 = tmp / "r1.fastq", tmp / "r2.fastq"
    write_reads(f1, reads1)
    write_reads(f2, reads2)
    return barcodes, str(f1), str(f2)


def _port_run(barcodes, f1, f2, engine, **kw):
    extra = next(x for _, mod, e, x in ENGINES if mod is thc and e == engine)
    return thc.run_count(set(barcodes), f1, f2, chunk_size=256, engine=engine, **extra, **kw)


@pytest.mark.parametrize("engine", ["vector", "device", "sharded"])
def test_checkpointed_run_matches_the_jax_package(tmp_path, read_files, engine):
    barcodes, f1, f2 = read_files
    ckpt = str(tmp_path / "counts.ckpt.npz")
    got = _port_run(barcodes, f1, f2, engine, checkpoint_path=ckpt, checkpoint_every=2)
    want = jhc.run_count(set(barcodes), f1, f2, chunk_size=256)
    assert got[:3] == want[:3]
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("engine", ["vector", "device", "sharded"])
def test_resume_from_partial_checkpoint(tmp_path, monkeypatch, read_files, engine):
    """Crash mid-stream after several checkpoints, resume: the counts equal
    the JAX package's uninterrupted run. A checkpoint taken while batches
    are in flight must include them (save drains first)."""
    barcodes, f1, f2 = read_files
    ckpt = str(tmp_path / "counts.ckpt.npz")
    # each engine's own chunk entry point: VectorCounter's, or CudaCounter's
    # (which ShardedCounter's calls)
    origs = {cls: cls.process_matrices for cls in (thc.VectorCounter, thc.CudaCounter)}
    calls = {"n": 0}

    class Boom(Exception):
        pass

    def crashing(orig):
        def process_matrices(self, m1, m2):
            calls["n"] += 1
            if calls["n"] > 6:
                raise Boom()
            return orig(self, m1, m2)

        return process_matrices

    for cls, orig in origs.items():
        monkeypatch.setattr(cls, "process_matrices", crashing(orig))
    monkeypatch.setattr(thc.CudaCounter, "_DISPATCH_ROWS", 300)
    with pytest.raises(Boom):
        _port_run(barcodes, f1, f2, engine, checkpoint_path=ckpt, checkpoint_every=2)
    for cls, orig in origs.items():
        monkeypatch.setattr(cls, "process_matrices", orig)
    assert os.path.exists(ckpt)
    got = _port_run(barcodes, f1, f2, engine, checkpoint_path=ckpt, checkpoint_every=2)
    want = jhc.run_count(set(barcodes), f1, f2, chunk_size=256)
    assert got[:3] == want[:3]


def test_checkpoint_file_is_the_jax_packages(tmp_path, read_files):
    """The port reads a checkpoint the JAX package wrote (same format, same
    config hash), and keeps the owned_reads bookkeeping."""
    barcodes, f1, f2 = read_files
    _, _, _, info = jhc.run_count(set(barcodes), f1, f2, chunk_size=1024)
    jcfg = info["config"]
    vc = jhc.VectorCounter(jcfg)
    vc.doc_counts[:] = np.arange(len(vc.doc_counts))
    vc.undoc["ACGT*"] = 3
    vc.total_reads = 77
    vc.owned_reads = 123
    path = str(tmp_path / "c.npz")
    jhc._CheckpointState(path, jcfg).save(vc, chunk_no=4)
    tcfg = thc.CountConfig(**{k: getattr(jcfg, k) for k in (
        "barcodes", "bc_len", "L_fwd", "R_fwd", "L_rev", "R_rev", "L_fwd_start",
        "L_rev_start", "need_swap")})
    ckpt = thc._CheckpointState(path, tcfg)
    assert ckpt.cfg_hash == jhc._CheckpointState(path, jcfg).cfg_hash
    cc = thc.CudaCounter(tcfg, device="cpu")
    assert ckpt.restore(cc) == 4
    assert (cc.doc_counts == vc.doc_counts).all()
    assert (cc.total_reads, cc.undoc) == (77, Counter({"ACGT*": 3}))
    assert not hasattr(cc, "owned_reads")
    cc.owned_reads = 0
    assert ckpt.restore(cc) == 4 and cc.owned_reads == 123


# --- CudaCounter's lifecycle (TestDeviceEngine, test_pending_queue_is_bounded) --

def _dispatch_threads():
    return [t for t in threading.enumerate() if t.name == "count-dispatch"]


def test_dispatch_worker_error_surfaces(tmp_path, monkeypatch):
    """A dispatch failure on the worker thread raises on the caller's
    thread, never hangs, and the error path tears the worker down."""
    boom = RuntimeError("injected dispatch failure")

    def bad_dispatch(self, *a, **k):
        raise boom

    monkeypatch.setattr(thc.CudaCounter, "_device_match_async", bad_dispatch)
    monkeypatch.setattr(thc.CudaCounter, "_DISPATCH_ROWS", 256)
    barcodes = make_barcodes(n=12, seed=7)
    reads1, _, _ = make_reads(barcodes, n_reads=2000, seed=7)
    f1, _ = _files(tmp_path, reads1)
    with pytest.raises(RuntimeError, match="injected dispatch"):
        thc.run_count(set(barcodes), f1, engine="device", chunk_size=256, device="cpu")
    assert not _dispatch_threads()


def test_abort_on_midstream_reader_error(tmp_path, monkeypatch):
    """A reader error mid-stream (paired-end length mismatch) tears the
    worker down through run_count's vc.abort()."""
    monkeypatch.setattr(thc.CudaCounter, "_DISPATCH_ROWS", 256)
    aborted = []
    orig_abort = thc.CudaCounter.abort
    monkeypatch.setattr(thc.CudaCounter, "abort",
                        lambda self: (aborted.append(len(self._pending)), orig_abort(self)))
    barcodes = make_barcodes(n=12, seed=9)
    reads1, reads2, _ = make_reads(barcodes, n_reads=2000, seed=9)
    f1, f2 = _files(tmp_path, reads1, reads2[:1200])
    with pytest.raises(ValueError, match="paired-end"):
        thc.run_count(set(barcodes), f1, f2, engine="device", chunk_size=256, device="cpu")
    assert len(aborted) == 1
    assert not _dispatch_threads()


def test_dispatch_worker_stops_after_drain(tmp_path):
    barcodes = make_barcodes(n=12, seed=8)
    reads1, _, truth = make_reads(barcodes, n_reads=1500, seed=8)
    f1, _ = _files(tmp_path, reads1)
    doc, _, _, _ = thc.run_count(set(barcodes), f1, engine="device", device="cpu")
    assert doc == truth
    assert not _dispatch_threads()


def test_acc_spill_mid_stream(tmp_path, monkeypatch):
    """Every dispatch spills the accumulator mid-stream: the spills and the
    final fetch compose additively, never double- or drop-counting."""
    monkeypatch.setattr(thc.CudaCounter, "_ACC_SPILL_ROWS", 1)
    monkeypatch.setattr(thc.CudaCounter, "_DISPATCH_ROWS", 512)
    fetches = []
    orig_fetch = thc.CudaCounter._fetch_acc
    monkeypatch.setattr(thc.CudaCounter, "_fetch_acc",
                        lambda self: (fetches.append(any(a is not None for a in self._accs)),
                                       orig_fetch(self)))
    barcodes = make_barcodes(n=25, seed=4)
    reads1, _, truth = make_reads(barcodes, n_reads=2500, seed=4)
    f1, _ = _files(tmp_path, reads1)
    doc, undoc, n, _ = thc.run_count(set(barcodes), f1, engine="device", chunk_size=512,
                                     device="cpu")
    assert doc == truth and n == 2500
    assert sum(fetches) >= 4  # one spill per dispatch of 512 rows


def test_pending_queue_is_bounded(read_files):
    """The pipelining queue holds at most _MAX_PENDING batches."""
    barcodes, f1, f2 = read_files
    _, _, _, info = thc.run_count(set(barcodes), f1, f2, chunk_size=1024, engine="vector")
    vc = thc.CudaCounter(info["config"], device="cpu")
    vc._DISPATCH_ROWS = 64  # flush every chunk so the queue actually fills
    rng = np.random.default_rng(0)
    max_seen = 0
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    for _ in range(vc._MAX_PENDING * 3):
        m1, m2 = (acgt[rng.integers(0, 4, size=(64, 80))] for _ in range(2))
        vc.process_matrices(m1, m2)
        max_seen = max(max_seen, len(vc._pending))
    assert max_seen <= vc._MAX_PENDING
    vc.drain()
    assert vc._pending == []
    assert not _dispatch_threads()


def test_dispatches_count_only_the_card():
    """The CPU run matches through the same code but is not a card
    dispatch: the class-wide counters stay where they were."""
    barcodes = make_barcodes(n=12, seed=5)
    reads1, _, truth = make_reads(barcodes, n_reads=600, seed=5)
    before = (thc.CudaCounter.dispatches, thc.CudaCounter.match_ms)
    cc = thc.CudaCounter(thc.CountConfig(barcodes=set(barcodes), bc_len=20, L_fwd=L_FLANK,
                                         R_fwd=R_FLANK, L_fwd_start=len(PREFIX)),
                         device="cpu")
    cc.process_chunk((reads1, None))
    assert cc.results()[0] == truth
    assert (thc.CudaCounter.dispatches, thc.CudaCounter.match_ms) == before


# --- what the port refuses ------------------------------------------------------

def test_sharded_engine_raises(tmp_path, monkeypatch):
    """The sharded engine's default read mesh is the cards: without one it
    raises, as every card engine does. Asked for the CPU (a CPU read mesh,
    or set_platform("cpu") as BARCODER_TPU_PLATFORM=cpu does) it counts as
    the host engine does."""
    from barcoder_tpu_torch.parallel import mesh as port_mesh

    barcodes = make_barcodes(n=12, seed=2)
    reads1, _, _ = make_reads(barcodes, n_reads=200, seed=2)
    f1, _ = _files(tmp_path, reads1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thc.run_count(set(barcodes), f1, engine="sharded")
    want = thc.run_count(set(barcodes), f1, engine="vector")
    cpu_mesh = make_read_mesh(devices=[torch.device("cpu")] * 2)
    got = thc.run_count(set(barcodes), f1, engine="sharded", mesh=cpu_mesh)
    assert got[:3] == want[:3] and got[3]["engine"] == "sharded"
    assert got[3]["owned_reads"] == 200
    monkeypatch.setattr(port_mesh, "_platform", "cpu")
    assert thc.run_count(set(barcodes), f1, engine="sharded")[:3] == want[:3]


def test_device_counter_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = thc.CountConfig(barcodes=set(make_barcodes(n=10)), bc_len=20)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        thc.CudaCounter(cfg)
    assert thc.CudaCounter(cfg, device="cpu").device == torch.device("cpu")


# --- the count CLI --------------------------------------------------------------

@pytest.mark.parametrize("engine", ["vector", "reference"])
@pytest.mark.parametrize("paired", [False, True])
def test_cli_stdout_equals_the_jax_clis(tmp_path, capsys, engine, paired):
    barcodes = make_barcodes(n=12, seed=13)
    reads1, reads2, truth = make_reads(barcodes, n_reads=1500, seed=13,
                                       undocumented=[random_seq(20, np.random.default_rng(3))])
    f1, f2 = _files(tmp_path, reads1, reads2 if paired else None)
    bc_fasta = tmp_path / "bc.fasta"
    bc_fasta.write_text("".join(f">{b}\n{b}\n" for b in barcodes))
    argv = [str(bc_fasta), f1] + ([f2] if paired else []) + ["--engine", engine]
    assert ref_cli(argv) == 0
    want = capsys.readouterr().out
    assert port_cli(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert dict(line.split("\t") for line in got.splitlines()) == {
        bc: str(truth[bc]) for bc in barcodes if truth[bc]}


@pytest.mark.parametrize("engine", ["device", "auto"])
def test_cli_device_engine_refuses_without_a_card(tmp_path, capsys, monkeypatch, engine):
    """``--engine device``, and ``auto`` (the default) with it, never fall
    back to the host: without CUDA the CLI reports the error and exits 1
    with nothing on stdout."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    barcodes = make_barcodes(n=12, seed=13)
    reads1, _, _ = make_reads(barcodes, n_reads=300, seed=13)
    f1, _ = _files(tmp_path, reads1)
    bc_fasta = tmp_path / "bc.fasta"
    bc_fasta.write_text("".join(f">{b}\n{b}\n" for b in barcodes))
    assert port_cli([str(bc_fasta), f1, "--engine", engine]) == 1
    assert capsys.readouterr().out == ""
