"""The port's multi-host layer against the JAX package: 2 real processes x
4 CPU shards each, joined by ``barcoder_tpu_torch.parallel.multihost``
(gloo over a localhost rendezvous), run the port's sharded scan (site,
dense, a 2-D mesh whose library axis crosses the process boundary,
``sharded_scan_many``, ``run_targets``), ``ShardedCounter``, the
owned-chunk ``run_count`` (checkpoints and their resume agreement
included) and the multi-host ``distill``. Every process must return the
same results, equal to the JAX package's on the same inputs in this
process (its sharded scan on conftest's 8 fake devices, ``VectorCounter``,
``run_count``), and to the planted guides. The cases are those of the
JAX package's ``tests/multihost_worker.py`` and ``tests/test_multihost.py``.

This file is also its own worker: ``python tests/test_torch_multihost.py
<process_id> <num_processes> <port> <spec.json> <out.json>`` imports
nothing of jax or of the JAX package (the parent builds the inputs and
writes them to files) and reports what it loaded.

The ``targets`` and ``count`` CLIs run twice under the multi-host env
(``BARCODER_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID`` and
``BARCODER_TPU_PLATFORM=cpu``) and once alone: the same stdout bytes.
"""

import json
import os
import sys
from collections import Counter

import numpy as np
import pytest

from barcoder_tpu_torch.parallel.multihost import free_port, spawn_joined

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240


def _hit_rows(h) -> list:
    return sorted(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                      h.mismatches.tolist()))


def _port_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BARCODER_TPU")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


# --- the inputs, built in the parent with the JAX package's test helpers ------

def _scan_case():
    """tests/multihost_worker.py's scan case: 9 kb circular genome, five
    planted 20-nt guides (TGG PAMs, both strands)."""
    from barcoder_tpu.core.genome import contig_from_record

    from .genomes import make_record, plant_guide, random_seq

    rng = np.random.default_rng(0)
    rec = make_record(n=9000, topology="circular", seed=0)
    spacers = [random_seq(20, rng) for _ in range(5)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 700 + 1500 * i, pam="TGG", strand="F" if i % 2 else "R")
    libs = []
    for i in range(4):
        rng_i = np.random.default_rng(100 + i)
        libs.append([random_seq(20, rng_i) for _ in range(3)])
    libs[0][0] = spacers[0]  # one planted guide among the served libraries
    return rec, contig_from_record(rec), spacers, libs


def _cfg_fields(cfg) -> dict:
    return {k: getattr(cfg, k) for k in ("bc_len", "L_fwd", "R_fwd", "L_rev", "R_rev",
                                         "L_fwd_start", "L_rev_start", "need_swap")}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from barcoder_tpu.seqio.genbank import write_genbank

    from .genomes import random_seq
    from .test_distill import make_distill_reads
    from .test_heuristic_count import (
        L_FLANK, PREFIX, R_FLANK, make_barcodes, make_reads, paired_cfg, write_reads,
        write_run_count_fastq,
    )

    d = tmp_path_factory.mktemp("torch_mh")
    rec, contig, spacers, libs = _scan_case()
    write_genbank([rec], d / "genome.gb")
    barcodes = make_barcodes(n=10, seed=2)
    reads1, _, _ = make_reads(barcodes, n_reads=777, seed=2)
    undoc_bc = [random_seq(20, np.random.default_rng(77))]
    reads1p, reads2p, _ = make_reads(barcodes, n_reads=501, seed=3, undocumented=undoc_bc)
    write_run_count_fastq(d / "rc.fastq", barcodes)
    r1mh, r2mh, _ = make_reads(barcodes, n_reads=1300, seed=9,
                               undocumented=[random_seq(20, np.random.default_rng(55))])
    write_reads(d / "p1.fastq", r1mh)
    write_reads(d / "p2.fastq", r2mh)
    dr1, dr2 = make_distill_reads()
    for name, reads in (("d1.fastq", dr1), ("d2.fastq", dr2)):
        with open(d / name, "w") as fh:
            for i, rd in enumerate(reads):
                fh.write(f"@d{i}\n{rd}\n+\n{'I' * len(rd)}\n")
    spec = {
        "dir": str(d), "genome": str(d / "genome.gb"), "spacers": spacers, "libs": libs,
        "barcodes": barcodes, "reads1": reads1, "reads1p": reads1p, "reads2p": reads2p,
        "cfg": {"bc_len": 20, "L_fwd": L_FLANK, "R_fwd": R_FLANK, "L_rev": None,
                "R_rev": None, "L_fwd_start": len(PREFIX), "L_rev_start": None,
                "need_swap": False},
        "paired_cfg": _cfg_fields(paired_cfg(barcodes)),
        "rc_fastq": str(d / "rc.fastq"), "p1": str(d / "p1.fastq"), "p2": str(d / "p2.fastq"),
        "d1": str(d / "d1.fastq"), "d2": str(d / "d2.fastq"),
    }
    (d / "spec.json").write_text(json.dumps(spec))
    return dict(dir=d, rec=rec, contig=contig, spacers=spacers, libs=libs, barcodes=barcodes,
                reads1=reads1, reads1p=reads1p, reads2p=reads2p, undoc_bc=undoc_bc,
                r1mh=r1mh, r2mh=r2mh, dr1=dr1, dr2=dr2)


@pytest.fixture(scope="module")
def worker_results(inputs):
    d = inputs["dir"]
    port = free_port()  # taken just before the spawn
    cmds = [[sys.executable, os.path.abspath(__file__), str(pid), "2", str(port),
             str(d / "spec.json"), str(d / f"res{pid}.json")] for pid in range(2)]
    env = dict(_port_env(), BARCODER_TPU_ARTIFACTS=str(d / "artifacts"))
    logs = spawn_joined(cmds, [env] * 2, REPO, WORKER_TIMEOUT_S)
    for rc, _stdout, stderr, _s in logs:
        assert rc == 0, f"worker failed:\n{stderr[-3000:]}"
    return [json.loads((d / f"res{pid}.json").read_text()) for pid in range(2)]


# --- the comparisons ------------------------------------------------------------

def test_workers_join_and_never_import_jax(worker_results):
    for pid, r in enumerate(worker_results):
        assert r["process_index"] == pid
        assert r["process_count"] == 2
        assert r["global_shards"] == 8
        assert r["mesh_processes"] == [0] * 4 + [1] * 4
        assert r["jax"] == []


def test_a_mesh_without_a_shard_of_each_process_is_refused(worker_results):
    """Over 2 x 4 shards, ``make_mesh(4)``, ``make_mesh_2d(1, 4)`` and
    ``make_read_mesh(4)`` would hold process 0's shards alone: process 1
    would return no hits and process 0 would scan alone, so every process
    refuses them, as each refuses a mesh without a shard of its own."""
    for r in worker_results:
        assert r["cut_meshes_refused"] == [True] * 4


@pytest.mark.parametrize("processes", [[1, 1], [0, 1]])
def test_a_one_process_mesh_holds_only_its_own_shards(processes):
    """Without a multi-process group, a mesh whose shards name another
    process (alone, or beside this one) is refused."""
    import torch

    from barcoder_tpu_torch.parallel.mesh import GENOME_AXIS, Mesh, _device_array

    devices = _device_array([torch.device("cpu")] * 2, (2,))
    with pytest.raises(ValueError, match="must hold one of this process"):
        Mesh(devices, (GENOME_AXIS,), np.array(processes))
    assert Mesh(devices, (GENOME_AXIS,)).processes.tolist() == [0, 0]


def test_scans_match_the_jax_package(inputs, worker_results):
    """Site and dense scans over the process-spanning 8-shard mesh, the
    2-D mesh whose library rows sit on different processes, and
    sharded_scan_many: the same Hits on both processes, equal to the JAX
    sharded_scan on 8 fake devices here and holding every planted guide."""
    from barcoder_tpu.parallel.mesh import make_mesh, make_mesh_2d
    from barcoder_tpu.parallel.sharded_scan import sharded_scan, sharded_scan_many

    contig, spacers = inputs["contig"], inputs["spacers"]
    cases = {"hits_auto": dict(mesh=make_mesh(8), site_mode="auto", v=1),
             "hits_never": dict(mesh=make_mesh(8), site_mode="never", v=1),
             "hits_2d": dict(mesh=make_mesh_2d(2), site_mode="auto", v=2)}
    for key, kw in cases.items():
        want = _hit_rows(sharded_scan(spacers, contig, kw["v"], pam="NGG", mesh=kw["mesh"],
                                      P=256, site_mode=kw["site_mode"]))
        assert {(i, 0) for i in range(5)} <= {(s, m) for s, _, _, m in want}
        for r in worker_results:
            assert [tuple(t) for t in r[key]] == want, (r["process_index"], key)
    many = sharded_scan_many(inputs["libs"], contig, 1, pam="NGG", mesh=make_mesh(8), P=256,
                             max_pending=2)
    want_many = [_hit_rows(h) for h in many]
    assert sum(len(w) for w in want_many) >= 1
    for r in worker_results:
        assert [[tuple(t) for t in lib] for lib in r["serving_many"]] == want_many


def test_targets_pipeline_matches_the_jax_package(inputs, worker_results):
    """run_targets(backend="sharded") over the process-spanning mesh: the
    same TSV on both processes, equal to the JAX package's."""
    import hashlib

    from barcoder_tpu.core.genome import Genome
    from barcoder_tpu.pipeline.targets import run_targets
    from barcoder_tpu.seqio.library import BarcodeLibrary

    tr = run_targets(BarcodeLibrary.from_list(inputs["spacers"]),
                     Genome(contigs=[inputs["contig"]]), "NGG", 1, backend="sharded")
    assert len(tr.table) >= 5
    digest = hashlib.blake2b(tr.table.to_csv(sep="\t", index=False, na_rep="None").encode(),
                             digest_size=12).hexdigest()
    for r in worker_results:
        assert r["targets_tsv_digest"] == digest


def test_sharded_counter_matches_the_jax_package(inputs, worker_results):
    """ShardedCounter fed the same chunk on both processes (777 single-end
    reads, an odd count, and 501 pairs with an undocumented barcode): both
    hold the global documented counts and total, equal to JAX
    VectorCounter's; the processes' undocumented tallies are disjoint
    windows whose union is VectorCounter's."""
    from barcoder_tpu.pipeline.heuristic_count import CountConfig, VectorCounter

    from .test_heuristic_count import L_FLANK, PREFIX, R_FLANK, paired_cfg

    barcodes = inputs["barcodes"]
    vc = VectorCounter(CountConfig(barcodes=set(barcodes), bc_len=20, L_fwd=L_FLANK,
                                   R_fwd=R_FLANK, L_fwd_start=len(PREFIX)))
    vc.process_chunk((inputs["reads1"], None))
    doc, undoc = vc.results()
    vp = VectorCounter(paired_cfg(barcodes))
    vp.process_chunk((inputs["reads1p"], inputs["reads2p"]))
    doc_p, undoc_p = vp.results()
    assert sum(undoc_p.values()) > 0
    merged, merged_p = Counter(), Counter()
    for r in worker_results:
        assert Counter(dict(r["counts"])) == doc
        assert r["total_reads"] == len(inputs["reads1"])
        assert Counter(dict(r["counts_paired"])) == doc_p
        assert r["total_reads_paired"] == len(inputs["reads1p"])
        merged.update(dict(r["undoc_local"]))
        merged_p.update(dict(r["undoc_paired_local"]))
    assert merged == undoc and merged_p == undoc_p
    assert [r["owned_reads"] for r in worker_results] == [389, 388]


def test_owned_chunk_run_count_matches_the_jax_package(inputs, worker_results):
    """run_count with engine="auto" resolves to sharded under two
    processes; each parses only its own chunks (chunk_size=256), and both
    return the global doc, undoc and total of the JAX package's run_count.
    The same for 1,300 pairs with engine="sharded"."""
    from barcoder_tpu.pipeline.heuristic_count import run_count

    d, barcodes = inputs["dir"], set(inputs["barcodes"])
    for key, files in (("run_count", (d / "rc.fastq",)),
                       ("run_count_paired", (d / "p1.fastq", d / "p2.fastq"))):
        doc, undoc, total, _ = run_count(barcodes, *map(str, files), engine="vector",
                                         chunk_size=256)
        assert sum(undoc.values()) > 0
        for r in worker_results:
            assert Counter(dict(r[key])) == doc, key
            assert Counter(dict(r[key + "_undoc"])) == undoc, key
            assert r[key + "_total"] == total, key
        owned = [r[key + "_owned"] for r in worker_results]
        assert all(o > 0 for o in owned) and sum(owned) == total, (key, owned)
    assert all(r["run_count_engine"] == "sharded" for r in worker_results)


def test_flush_windows_and_checkpoint_drains(worker_results):
    """A 512-row dispatch buffer makes each process flush mid-stream (two
    batches each: its first two owned chunks, then the rest), and
    checkpoints every 2 chunks drain mid-stream: both land on the plain
    run's counts."""
    for r in worker_results:
        assert r["flush_windows_match"] and r["ckpt_interleave_match"]
        assert r["flush_rows"][0] == 512 and len(r["flush_rows"]) == 2, r["flush_rows"]


def test_checkpoint_agreement_and_resume(worker_results):
    """Per-process checkpoints at different chunks are discarded in
    agreement (a recount from 0); checkpoints at the same chunk with real
    partial counts resume from it. Both reach the plain run's counts."""
    for r in worker_results:
        assert r["ckpt_disagree_matches"], r["process_index"]
        assert r["ckpt_resume_matches"], r["process_index"]
        assert r["ckpt_resume_skipped"] == 4


def test_multihost_distill(inputs, worker_results):
    """Each process spills a disjoint set of chunks into the shared
    checkpoint dir, process 0 merges: the outputs hold the one-process
    distill's sorted pairs."""
    from .test_distill import read_zst_lines

    r1, r2 = inputs["dr1"], inputs["dr2"]
    want = sorted(zip(r1, r2))
    outs = worker_results[0]["distill_outputs"]
    assert worker_results[1]["distill_outputs"] == outs
    assert read_zst_lines(outs[0]) == [a for a, _ in want]
    assert read_zst_lines(outs[1]) == [b for _, b in want]
    spilled = [set(r["distill_spilled_chunks"]) for r in worker_results]
    assert spilled[0] and spilled[1] and spilled[0].isdisjoint(spilled[1])
    assert spilled[0] | spilled[1] == set(range(-(-len(r1) // 128)))


def _cli_runs(argv, cwd) -> list:
    """stdout of ``argv`` in two processes joined by the env and in one
    process alone, all with BARCODER_TPU_PLATFORM=cpu."""
    base = dict(_port_env(), BARCODER_TPU_PLATFORM="cpu",
                BARCODER_TPU_ARTIFACTS=str(cwd / "artifacts"))
    port = free_port()
    envs = [dict(base, BARCODER_TPU_COORDINATOR=f"localhost:{port}",
                 BARCODER_TPU_NUM_PROCESSES="2", BARCODER_TPU_PROCESS_ID=str(pid))
            for pid in range(2)] + [base]
    runs = spawn_joined([argv] * 3, envs, cwd, WORKER_TIMEOUT_S)
    for rc, _stdout, stderr, _s in runs:
        assert rc == 0, stderr[-3000:]
    return [stdout for _, stdout, _, _ in runs]


def test_targets_cli_under_the_multihost_env(tmp_path):
    """`python -m barcoder_tpu_torch targets ... --backend sharded` in two
    processes joined only by the env: both print exactly the bytes a single
    process prints (the gloo shield keeps stdout clean), with every guide."""
    from barcoder_tpu.seqio.genbank import write_genbank

    from .genomes import make_record, plant_guide, random_seq

    rng = np.random.default_rng(3)
    rec = make_record(n=6000, topology="circular", seed=3, n_genes=5)
    guides = [random_seq(20, rng) for _ in range(4)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 600 + 1200 * i, pam="TGG")
    write_genbank([rec], tmp_path / "g.gb")
    (tmp_path / "lib.fasta").write_text("".join(f">g{i}\n{g}\n" for i, g in enumerate(guides)))
    outs = _cli_runs([sys.executable, "-m", "barcoder_tpu_torch", "targets",
                      str(tmp_path / "lib.fasta"), str(tmp_path / "g.gb"), "NGG", "1",
                      "--backend", "sharded"], tmp_path)
    assert outs[0] == outs[1] == outs[2]
    assert all(g in outs[0] for g in guides)


def test_count_cli_under_the_multihost_env(tmp_path):
    """`python -m barcoder_tpu_torch count ...` (engine auto: sharded under
    two processes, device alone, on CPU shards) in two processes joined by
    the env: the same bytes as a single process, every barcode listed."""
    from .test_heuristic_count import make_barcodes, write_run_count_fastq

    barcodes = make_barcodes(n=10, seed=2)
    write_run_count_fastq(tmp_path / "reads.fastq", barcodes)
    (tmp_path / "bc.fasta").write_text("".join(f">b{i}\n{b}\n" for i, b in enumerate(barcodes)))
    outs = _cli_runs([sys.executable, "-m", "barcoder_tpu_torch", "count",
                      str(tmp_path / "bc.fasta"), str(tmp_path / "reads.fastq")], tmp_path)
    assert outs[0] == outs[1] == outs[2]
    assert all(b in outs[0] for b in barcodes)


# --- the worker -------------------------------------------------------------------

def _worker(pid: int, nproc: int, port: str, spec_path: str, out_path: str) -> None:
    import torch

    torch.set_num_threads(1)
    from barcoder_tpu_torch.parallel import multihost

    assert multihost.initialize(f"localhost:{port}", nproc, pid)
    assert multihost.initialize()  # idempotent
    import hashlib

    from barcoder_tpu_torch.core.genome import Genome
    from barcoder_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d, set_platform
    from barcoder_tpu_torch.parallel.sharded_count import ShardedCounter, make_read_mesh
    from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan, sharded_scan_many
    from barcoder_tpu_torch.pipeline.heuristic_count import (
        CountConfig, _CheckpointState, discover_config, run_count,
    )
    from barcoder_tpu_torch.pipeline.targets import run_targets
    from barcoder_tpu_torch.seqio.fast_reader import iter_owned_matrix_chunks
    from barcoder_tpu_torch.seqio.library import BarcodeLibrary

    set_platform("cpu")  # default meshes: 4 CPU shards per process
    with open(spec_path) as fh:
        spec = json.load(fh)
    d = spec["dir"]
    contig = Genome.load(spec["genome"]).contigs[0]
    spacers = spec["spacers"]
    mesh = make_mesh()
    res = {"process_index": multihost.process_index(),
           "process_count": multihost.process_count(),
           "global_shards": int(mesh.devices.size),
           "mesh_processes": mesh.processes.tolist()}

    def refused(build) -> bool:
        try:
            build()
        except ValueError:
            return True
        return False

    # meshes cut to process 0's four shards (every process calls the
    # builders' all-gather, then refuses), and one of the other process's
    res["cut_meshes_refused"] = [refused(b) for b in (
        lambda: make_mesh(4), lambda: make_mesh_2d(1, 4), lambda: make_read_mesh(4),
        lambda: Mesh(mesh.devices[:4], mesh.axis_names, np.full(4, 1 - pid)))]
    for site_mode in ("auto", "never"):
        res[f"hits_{site_mode}"] = _hit_rows(
            sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=256, site_mode=site_mode))
    res["hits_2d"] = _hit_rows(sharded_scan(spacers, contig, 2, pam="NGG",
                                            mesh=make_mesh_2d(2), P=256))
    tr = run_targets(BarcodeLibrary.from_list(spacers), Genome(contigs=[contig]), "NGG", 1,
                     backend="sharded")
    res["targets_tsv_digest"] = hashlib.blake2b(
        tr.table.to_csv(sep="\t", index=False, na_rep="None").encode(),
        digest_size=12).hexdigest()
    res["serving_many"] = [_hit_rows(h) for h in sharded_scan_many(
        spec["libs"], contig, 1, pam="NGG", mesh=mesh, P=256, max_pending=2)]

    barcodes = set(spec["barcodes"])
    sc = ShardedCounter(CountConfig(barcodes=barcodes, **spec["cfg"]), mesh=make_read_mesh())
    sc.process_chunk((spec["reads1"], None))
    doc, undoc = sc.results()
    res.update(counts=sorted(doc.items()), undoc_local=sorted(undoc.items()),
               total_reads=sc.total_reads, owned_reads=sc.owned_reads)
    scp = ShardedCounter(CountConfig(barcodes=barcodes, **spec["paired_cfg"]),
                         mesh=make_read_mesh())
    scp.process_chunk((spec["reads1p"], spec["reads2p"]))
    doc_p, undoc_p = scp.results()
    res.update(counts_paired=sorted(doc_p.items()), undoc_paired_local=sorted(undoc_p.items()),
               total_reads_paired=scp.total_reads)

    fq = spec["rc_fastq"]

    def counted(got) -> dict:
        doc, undoc, total, info = got
        return dict(doc=sorted(doc.items()), undoc=sorted(undoc.items()), total=total,
                    engine=info["engine"], owned=info["owned_reads"])

    rc = counted(run_count(barcodes, fq, engine="auto", chunk_size=256))
    res.update(run_count=rc["doc"], run_count_undoc=rc["undoc"], run_count_total=rc["total"],
               run_count_engine=rc["engine"], run_count_owned=rc["owned"])

    def same(got) -> bool:
        return all(got[k] == rc[k] for k in ("doc", "undoc", "total"))

    # a 512-row dispatch buffer: each process's first two owned chunks
    # flush mid-stream, the rest at the end
    flush_rows = []
    orig_dispatch, orig_rows = ShardedCounter._device_match_async, ShardedCounter._DISPATCH_ROWS

    def recording(self, m1, m2, *staged):
        flush_rows.append(len(m1 if m1 is not None else m2))
        return orig_dispatch(self, m1, m2, *staged)

    ShardedCounter._device_match_async, ShardedCounter._DISPATCH_ROWS = recording, 512
    try:
        res["flush_windows_match"] = same(counted(run_count(barcodes, fq, engine="sharded",
                                                            chunk_size=256)))
    finally:
        ShardedCounter._device_match_async, ShardedCounter._DISPATCH_ROWS = (orig_dispatch,
                                                                             orig_rows)
    res["flush_rows"] = flush_rows
    res["ckpt_interleave_match"] = same(counted(run_count(
        barcodes, fq, engine="sharded", chunk_size=256,
        checkpoint_path=os.path.join(d, "ck_interleave.npz"), checkpoint_every=2)))
    pr = counted(run_count(barcodes, spec["p1"], spec["p2"], engine="sharded", chunk_size=256))
    res.update(run_count_paired=pr["doc"], run_count_paired_undoc=pr["undoc"],
               run_count_paired_total=pr["total"], run_count_paired_owned=pr["owned"])

    # checkpoints: (a) at different chunks on the two processes: discarded
    # in agreement, a recount from 0; (b) at the same chunk with real
    # partial counts from the owned feed: resumed
    _sample, cfg = discover_config(barcodes, fq, None, False)
    inputs = (fq, 256)
    bad = ShardedCounter(cfg, mesh=make_read_mesh())
    _CheckpointState(os.path.join(d, f"ck_a.npz.p{pid}"), cfg, inputs).save(
        bad, 4 if pid == 0 else 8)
    res["ckpt_disagree_matches"] = same(counted(run_count(
        barcodes, fq, engine="sharded", chunk_size=256,
        checkpoint_path=os.path.join(d, "ck_a.npz"))))
    part = ShardedCounter(cfg, mesh=make_read_mesh())
    for chunk_idx, nrec, r1, _r2 in iter_owned_matrix_chunks(fq, None, 256, owner=pid,
                                                              num_owners=nproc):
        if chunk_idx >= 4:
            break
        part.feed_owned(chunk_idx, nrec, r1[0] if r1 else None, None)
    _CheckpointState(os.path.join(d, f"ck_b.npz.p{pid}"), cfg, inputs).save(part, 4)
    resumed = []
    orig_feed = ShardedCounter.feed_owned

    def feed(self, chunk_idx, *a):
        resumed.append(chunk_idx)
        return orig_feed(self, chunk_idx, *a)

    ShardedCounter.feed_owned = feed
    try:
        res["ckpt_resume_matches"] = same(counted(run_count(
            barcodes, fq, engine="sharded", chunk_size=256,
            checkpoint_path=os.path.join(d, "ck_b.npz"))))
    finally:
        ShardedCounter.feed_owned = orig_feed
    res["ckpt_resume_skipped"] = min(resumed)

    from barcoder_tpu_torch.pipeline.distill import distill_reads

    class CapLog:
        def __init__(self):
            self.msgs = []

        def info(self, m):
            self.msgs.append(str(m))

        warn = info

    cap = CapLog()
    outs = [os.path.join(d, "distill_out1.reads.zst"), os.path.join(d, "distill_out2.reads.zst")]
    res["distill_outputs"] = distill_reads([spec["d1"], spec["d2"]], outs, chunk_size=128,
                                           log=cap,
                                           checkpoint_dir=os.path.join(d, "distill_ckpt"))
    res["distill_spilled_chunks"] = sorted(int(m.split("spilled chunk ")[1].split()[0])
                                           for m in cap.msgs if "spilled chunk" in m)
    res["jax"] = sorted(m for m in sys.modules if m in ("jax", "barcoder_tpu")
                        or m.startswith(("jax.", "jaxlib", "barcoder_tpu.")))
    with open(out_path, "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
