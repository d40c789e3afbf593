"""The counting kernel (``ops/count_match.py``: ``csrc/count_match.cu`` on
the card, its plain torch twin ``count_match_reference`` on the CPU) and
the counters that run it.

On the CPU the twin runs through ``CudaCounter(device="cpu")`` and through
``ShardedCounter`` on a mesh of CPU shards, held against ``VectorCounter``
and the per-read oracle ``count_chunk_reference`` on seeded reads that mix
every case of the per-read contract: flank misses, an N inside and outside
the core, lowercase cores, truncated windows, forward and reverse
single-end and paired reads, 20- and 32-nt barcodes. The ``gpu``-marked
tests hold the kernel equal to the twin on the same device tensors, at the
``eco-count`` cell's batch shape and on the edge shapes, and check the
launch and row counters. This file imports no jax, so on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_count_kernel.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

import barcoder_tpu_torch.pipeline.heuristic_count as hc
from barcoder_tpu_torch.ops import count_match as cm
from barcoder_tpu_torch.parallel.sharded_count import ShardedCounter, make_read_mesh

torch.set_num_threads(1)

ACGT = "ACGT"


def _random(rng, n: int) -> str:
    return "".join(ACGT[i] for i in rng.integers(0, 4, n))


def _barcodes(rng, n: int, bc_len: int) -> list:
    out = set()
    while len(out) < n:
        out.add(_random(rng, bc_len))
    return sorted(out)


# what each generated read is, with its share of the reads
KINDS = {"doc": 0.50, "undoc": 0.12, "flank_miss": 0.07, "n_core": 0.05, "n_outside": 0.05,
         "lowercase": 0.07, "lowercase_outside": 0.04, "truncated": 0.07, "inconsistent": 0.03}


def _core(rng, kind: str, barcodes: list, bc_len: int) -> str:
    core = barcodes[int(rng.integers(0, len(barcodes)))]
    if kind == "undoc":
        core = _random(rng, bc_len)
    elif kind == "n_core":
        j = int(rng.integers(0, bc_len))
        core = core[:j] + "N" + core[j + 1 :]
    elif kind == "lowercase":
        j = int(rng.integers(0, bc_len))
        core = core[:j] + core[j].lower() + core[j + 1 :]
    return core


def make_case(seed: int, *, layout: str, bc_len: int = 20, n_reads: int = 1500,
              n_barcodes: int = 40, extra_barcodes=()):
    """(CountConfig spec, reads1, reads2) of a seeded read set of ``layout``
    (``forward``, ``reverse`` single-end or ``paired``). A forward read is
    prefix + L + core + R + tail; a reverse read (and mate 2) carries the
    reverse complement of that, behind its own prefix and flanks."""
    rng = np.random.default_rng(seed)
    barcodes = _barcodes(rng, n_barcodes, bc_len) + list(extra_barcodes)
    L1, R1, L2, R2 = "GGTAGCT", "CTTAAGC", "TTGCA", "AGGAC"
    start1, start2 = 5, 3
    kinds = list(KINDS)
    p = np.array(list(KINDS.values()))
    reads1, reads2 = [], []
    for _ in range(n_reads):
        kind = kinds[int(rng.choice(len(kinds), p=p / p.sum()))]
        core = _core(rng, kind, barcodes, bc_len)
        f1 = _random(rng, start1) + L1 + core + R1 + _random(rng, int(rng.integers(0, 12)))
        core2 = hc.rev_comp(core)
        f2 = _random(rng, start2) + L2 + core2 + R2 + _random(rng, int(rng.integers(0, 12)))
        if kind == "flank_miss":  # one byte of one flank of one mate
            mate = int(rng.integers(0, 2))
            s, start, L, R = (f1, start1, L1, R1) if mate == 0 else (f2, start2, L2, R2)
            at = start + (int(rng.integers(0, len(L))) if rng.random() < 0.5
                          else len(L) + bc_len + int(rng.integers(0, len(R))))
            s = s[:at] + ("A" if s[at] != "A" else "C") + s[at + 1 :]
            f1, f2 = (s, f2) if mate == 0 else (f1, s)
        elif kind == "n_outside":
            f1 = "N" + f1[1:] if rng.random() < 0.5 else f1 + "N"
            f2 = f2[:-1] + "N" if rng.random() < 0.5 else f2
        elif kind == "lowercase_outside":
            f1, f2 = f1[:2].lower() + f1[2:], f2[:1].lower() + f2[1:]
        elif kind == "truncated":
            if rng.random() < 0.5:
                f1 = f1[: int(rng.integers(1, start1 + len(L1) + bc_len + len(R1)))]
            else:
                f2 = f2[: int(rng.integers(1, start2 + len(L2) + bc_len + len(R2)))]
        elif kind == "inconsistent":
            other = barcodes[int(rng.integers(0, len(barcodes)))]
            f2 = f2[: start2 + len(L2)] + hc.rev_comp(other) + f2[start2 + len(L2) + bc_len :]
        reads1.append(f1)
        reads2.append(f2)
    spec = dict(barcodes=set(barcodes), bc_len=bc_len)
    if layout in ("forward", "paired"):
        spec.update(L_fwd=L1, R_fwd=R1, L_fwd_start=start1)
    if layout in ("reverse", "paired"):
        spec.update(L_rev=L2, R_rev=R2, L_rev_start=start2)
    if layout == "forward":
        return spec, reads1, None
    if layout == "reverse":
        return spec, None, reads2
    return spec, reads1, reads2


def oracle(spec, reads1, reads2):
    """The per-read oracle's (doc, undoc). On single-end reverse reads
    VectorCounter (so the JAX package) writes an undocumented core through
    its codes, a non-ACGT byte as N, where the oracle keeps the byte: the
    undocumented keys are written as VectorCounter writes them there."""
    counts, _ = hc.count_chunk_reference((reads1, reads2), hc.CountConfig(**spec))
    undoc = Counter({k: v for k, v in counts.items() if k.endswith("*")})
    if reads1 is None:
        undoc = Counter({"".join(c if c in ACGT + "*" else "N" for c in k): v
                         for k, v in undoc.items()})
    return Counter({k: v for k, v in counts.items() if not k.endswith("*")}), undoc


def vector(spec, reads1, reads2):
    vc = hc.VectorCounter(hc.CountConfig(**spec))
    # its native single-end path counts a lowercase core as its uppercase
    # barcode (a fault of the JAX package that the port's copy keeps)
    vc._try_native_single_end = lambda *a: False
    vc.process_chunk((reads1, reads2))
    return vc.results()


def counted(counter, reads1, reads2, chunk: int = 400):
    n = len(reads1 if reads1 is not None else reads2)
    for i in range(0, n, chunk):
        counter.process_chunk((None if reads1 is None else reads1[i : i + chunk],
                               None if reads2 is None else reads2[i : i + chunk]))
    got = counter.results()
    assert counter.total_reads == n
    return got


def cpu_counters(spec):
    """CudaCounter on the CPU, and ShardedCounter on three CPU shards, each
    dispatching batches that straddle the 400-read chunks."""
    cc = hc.CudaCounter(hc.CountConfig(**spec), device="cpu")
    sc = ShardedCounter(hc.CountConfig(**spec),
                        mesh=make_read_mesh(devices=[torch.device("cpu")] * 3))
    for c in (cc, sc):
        c._DISPATCH_ROWS = 700
    return {"device": cc, "sharded": sc}


CASES = [(layout, bc_len) for layout in ("forward", "reverse", "paired") for bc_len in (20, 32)]


@pytest.mark.parametrize("counter", ["device", "sharded"])
@pytest.mark.parametrize("layout,bc_len", CASES)
def test_twin_counts_as_vector_counter_and_the_oracle(layout, bc_len, counter):
    spec, reads1, reads2 = make_case(11 + bc_len, layout=layout, bc_len=bc_len)
    got = counted(cpu_counters(spec)[counter], reads1, reads2)
    want = vector(spec, reads1, reads2)
    assert got == want
    assert got == oracle(spec, reads1, reads2)
    assert sum(got[0].values()) > 0 and sum(got[1].values()) > 0


@pytest.mark.parametrize("layout", ["forward", "reverse", "paired"])
def test_all_t_32nt_barcode_counts_as_the_oracle_does(layout):
    """The 32-nt all-T barcode's key is ~0, the sentinel of a non-ACGT core:
    the twin matches only a pure-ACGT core, so it counts the all-T reads as
    the oracle does (VectorCounter files them as undocumented, a fault of
    the JAX package that the port's copy keeps)."""
    spec, reads1, reads2 = make_case(5, layout=layout, bc_len=32, n_reads=800,
                                     extra_barcodes=["T" * 32])
    L1, R1, L2, R2 = "GGTAGCT", "CTTAAGC", "TTGCA", "AGGAC"
    k = 7
    if reads1 is not None:
        reads1 = reads1 + ["AAAAA" + L1 + "T" * 32 + R1] * k
    if reads2 is not None:
        reads2 = reads2 + ["CCC" + L2 + "A" * 32 + R2] * k
    want = oracle(spec, reads1, reads2)
    assert want[0]["T" * 32] >= k
    for counter in cpu_counters(spec).values():
        assert counted(counter, reads1, reads2) == want


def test_pair_of_two_non_acgt_cores_is_undocumented():
    """A pair whose two cores each hold a non-ACGT byte packs both keys to
    the sentinel, so the two keys are equal and the pair is consistent:
    CudaCounter (the twin), ShardedCounter and VectorCounter all count
    mate 1's core as undocumented. The per-read oracle compares the cores'
    strings instead, which differ here, and drops the pair."""
    rng = np.random.default_rng(3)
    barcodes = _barcodes(rng, 12, 20)
    spec = dict(barcodes=set(barcodes), bc_len=20, L_fwd="AC", R_fwd="GT", L_rev="CA",
                R_rev="TG", L_fwd_start=0, L_rev_start=0)
    core1 = barcodes[0][:4] + "a" + barcodes[0][5:]  # lowercase at base 4
    core2 = hc.rev_comp(barcodes[0])
    core2 = core2[:2] + "g" + core2[3:]  # and at base 17 of its reverse complement
    reads1 = ["AC" + b + "GT" for b in barcodes] + ["AC" + core1 + "GT"] * 3
    reads2 = ["CA" + hc.rev_comp(b) + "TG" for b in barcodes] + ["CA" + core2 + "TG"] * 3
    want_doc = Counter({b: 1 for b in barcodes})
    counters_say = (want_doc, Counter({core1 + "*": 3}))
    assert vector(spec, reads1, reads2) == counters_say
    for counter in cpu_counters(spec).values():
        assert counted(counter, reads1, reads2) == counters_say
    assert oracle(spec, reads1, reads2) == (want_doc, Counter())


def test_truncated_rows_take_the_oracle_path_at_drain():
    """Truncated rows come back from the twin as a list, and the caller's
    thread counts them by the per-read oracle in drain(): until then
    doc_counts and undoc hold nothing of them."""
    spec, reads1, _ = make_case(8, layout="forward", n_reads=600)
    cc = hc.CudaCounter(hc.CountConfig(**spec), device="cpu")
    cc._DISPATCH_ROWS = 200
    for i in range(0, 600, 200):
        cc.process_chunk((reads1[i : i + 200], None))
    cc._work_q.join()
    assert cc.doc_counts.sum() == 0 and cc.undoc == Counter()
    assert sum(map(len, (a for a, _ in cc._spilled_slow))) == 0  # retired by drain alone
    assert cc.results() == vector(spec, reads1, None) == oracle(spec, reads1, None)
    assert cc._spilled_slow == []


def _table(keys_np, device, *, bc_len=20, starts=(5, 3)):
    keys = torch.from_numpy(np.sort(keys_np.view(np.int64))).to(device)
    rows = torch.from_numpy(np.argsort(keys_np.view(np.int64))).to(device)
    return cm.match_table(keys, rows, bc_len=bc_len, L1="GGTAGCT", R1="CTTAAGC", L2="TTGCA",
                          R2="AGGAC", start1=starts[0], start2=starts[1])


def _matrices(seed, layout, bc_len=20, n_reads=500, width=None):
    spec, reads1, reads2 = make_case(seed, layout=layout, bc_len=bc_len, n_reads=n_reads)
    lib = sorted(spec["barcodes"])

    def mat(reads):
        if reads is None:
            return None
        m = hc._to_matrix(reads)
        if width is not None:  # zero-padded wider, as a batch of mixed chunks is
            m = np.pad(m, ((0, 0), (0, width - m.shape[1])))
        return torch.from_numpy(m)

    return spec, lib, mat(reads1), mat(reads2)


@pytest.mark.parametrize("layout", ["forward", "reverse", "paired"])
def test_twin_rows_and_hits(layout):
    """The twin's own outputs: the hits land on each key's row, the two
    lists hold exactly the unmatched eligible and the truncated rows, and
    the wrapper sends a CPU tensor to the twin without counting a launch."""
    spec, lib, m1, m2 = _matrices(21, layout)
    keys = hc._pack_strings(lib)
    table = _table(keys, "cpu")
    acc = torch.zeros(len(lib), dtype=torch.int64)
    before = cm.launches
    idx, counts = cm.count_match(table, m1, m2, acc)
    assert cm.launches == before
    un, tr = cm.split_rows(idx.numpy(), counts.numpy())
    n = len(m1 if m1 is not None else m2)
    assert len(np.intersect1d(un, tr)) == 0 and len(un) + len(tr) <= n
    # truncated: a mate shorter than its window's end
    lens = [None if m is None else (m != 0).sum(dim=1).numpy() for m in (m1, m2)]
    ends = [5 + 7 + 20 + 7, 3 + 5 + 20 + 5]
    short = np.zeros(n, bool)
    for ln, end in zip(lens, ends):
        if ln is not None:
            short |= ln < end
    assert np.array_equal(tr, np.nonzero(short)[0]) and len(tr) > 0
    # unmatched and hits: each other row alone through VectorCounter's numpy path
    cfg = hc.CountConfig(**spec)
    doc_total = Counter()
    for i in np.nonzero(~short)[0]:
        vc = hc.VectorCounter(cfg)
        vc._try_native_single_end = lambda *a: False
        vc.process_matrices(*[None if m is None else m[i : i + 1].numpy() for m in (m1, m2)])
        doc, undoc = vc.results()
        assert (i in un) == bool(undoc), i
        doc_total += doc
    assert {lib[r]: c for r, c in enumerate(acc.tolist()) if c} == doc_total
    assert len(un) > 0 and sum(doc_total.values()) > 0


def test_empty_library_counts_as_vector_counter():
    """No barcode can match: CudaCounter counts an empty library's chunks
    as VectorCounter does (no undocumented tally, truncated rows by the
    oracle)."""
    spec, reads1, _ = make_case(4, layout="forward", n_reads=300)
    spec = {**spec, "barcodes": set()}
    cc = hc.CudaCounter(hc.CountConfig(**spec), device="cpu")
    assert counted(cc, reads1, None) == vector(spec, reads1, None)


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_twin(table_cpu, m1, m2, dev):
    """The kernel and the twin on the same device tensors: the same
    accumulator and the same two row lists."""
    table = table_cpu.to(dev)
    m1d = None if m1 is None else m1.to(dev)
    m2d = None if m2 is None else m2.to(dev)
    acc_k = torch.zeros(len(table.keys), dtype=torch.int64, device=dev)
    acc_t = torch.zeros_like(acc_k)
    before = cm.launches
    idx_k, cnt_k = cm.count_match(table, m1d, m2d, acc_k)
    assert cm.launches == before + 1
    idx_t, cnt_t = cm.count_match_reference(table, m1d, m2d, acc_t)
    assert torch.equal(acc_k, acc_t)
    assert torch.equal(cnt_k, cnt_t)
    got = cm.split_rows(idx_k.cpu().numpy(), cnt_k.cpu().numpy())
    want = cm.split_rows(idx_t.cpu().numpy(), cnt_t.cpu().numpy())
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    return acc_k, got


@pytest.mark.gpu
def test_kernel_equals_twin_at_the_cells_batch_shape(cuda):
    """eco-count's batch: 262,144 single-end 75-byte rows against 10,240
    20-nt keys, 3% of the cores outside the library, 0.5% of the reads
    with an N, some truncated."""
    rng = np.random.default_rng(19)
    B, n, W = 10_240, hc.CudaCounter._DISPATCH_ROWS, 75
    lib = _barcodes(rng, B, 20)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    m = acgt[rng.integers(0, 4, size=(n, W))]
    cores = np.frombuffer("".join(lib).encode(), dtype=np.uint8).reshape(B, 20)
    m[:, 5:12] = np.frombuffer(b"GGTAGCT", dtype=np.uint8)
    m[:, 12:32] = cores[rng.integers(0, B, n)]
    m[:, 32:39] = np.frombuffer(b"CTTAAGC", dtype=np.uint8)
    undoc = rng.random(n) < 0.03
    m[undoc, 12:32] = acgt[rng.integers(0, 4, size=(int(undoc.sum()), 20))]
    with_n = rng.random(n) < 0.005
    m[with_n, rng.integers(0, W, int(with_n.sum()))] = ord("N")
    short = rng.random(n) < 0.001
    m[short, 30:] = 0
    table = _table(hc._pack_strings(lib), "cpu")
    acc, (un, tr) = _kernel_vs_twin(table, torch.from_numpy(m), None, cuda)
    assert int(acc.sum()) > 0.9 * n and len(un) > 0.02 * n and len(tr) == int(short.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("layout,bc_len,n_reads,width", [
    ("forward", 20, 1_003, None),    # a ragged last block
    ("reverse", 20, 777, None),
    ("paired", 20, 2_049, None),
    ("forward", 32, 1_500, None),
    ("paired", 32, 1_500, None),
    ("paired", 20, 700, 900),        # rows too wide to stage: read from global memory
    ("forward", 20, 1_000, 130),     # zero-padded wider than the reads
])
def test_kernel_equals_twin_on_edge_shapes(cuda, layout, bc_len, n_reads, width):
    spec, lib, m1, m2 = _matrices(31 + n_reads, layout, bc_len=bc_len, n_reads=n_reads,
                                  width=width)
    table = _table(hc._pack_strings(lib), "cpu", bc_len=bc_len)
    _kernel_vs_twin(table, m1, m2, cuda)


@pytest.mark.gpu
def test_kernel_on_a_batch_with_no_match(cuda):
    """Every row eligible and unmatched: the front list holds every row."""
    spec, lib, m1, _ = _matrices(2, "forward", n_reads=3_000)
    rng = np.random.default_rng(2)
    others = [b for b in _barcodes(rng, 400, 20) if b not in spec["barcodes"]]
    table = _table(hc._pack_strings(others), "cpu")
    m = hc._to_matrix(["AAAAA" + "GGTAGCT" + lib[i % len(lib)] + "CTTAAGC" for i in range(3_000)])
    acc, (un, tr) = _kernel_vs_twin(table, torch.from_numpy(m), None, cuda)
    assert int(acc.sum()) == 0 and np.array_equal(un, np.arange(3_000)) and len(tr) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["forward", "reverse", "paired"])
def test_cuda_counter_runs_every_batch_through_the_kernel(cuda, layout):
    """CudaCounter and ShardedCounter on the card: counts equal to the twin's
    counters on the CPU, one kernel launch per dispatched batch and shard,
    and card_rows + host_rows the rows counted, host_rows the truncated."""
    spec, reads1, reads2 = make_case(41, layout=layout, n_reads=3_000)
    want = counted(cpu_counters(spec)["device"], reads1, reads2)
    for name, counter in (
            ("device", hc.CudaCounter(hc.CountConfig(**spec))),
            ("sharded", ShardedCounter(hc.CountConfig(**spec),
                                       mesh=make_read_mesh(devices=[cuda] * 2)))):
        counter._DISPATCH_ROWS = 1_000
        hc.CudaCounter.dispatches = hc.CudaCounter.card_rows = hc.CudaCounter.host_rows = 0
        before = cm.launches
        assert counted(counter, reads1, reads2) == want, name
        shards = 2 if name == "sharded" else 1
        assert hc.CudaCounter.dispatches == cm.launches - before == 3 * shards
        assert hc.CudaCounter.card_rows + hc.CudaCounter.host_rows == 3_000
        assert 0 < hc.CudaCounter.host_rows < 0.2 * 3_000
