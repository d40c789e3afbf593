"""The plain reference against the program's plain torch path, at sizes the
CPU holds: every row of ``run_targets``' table with ``backend="torch"``,
with hits across the origin, on both strands, at every mismatch budget, in
genes, in the gene across the origin and between genes; and the count
truth against ``run_count``."""

import numpy as np
import pytest

from portbench import gen, workloads
from portbench.reference import count_ref, targets_ref

from .conftest import COUNT_CELLS, SEED, TARGET_CELLS, small_run


def planted(n: int, L: int, pam: str, seed: int):
    """A circular contig with spacers planted across the origin and near it
    on both strands, each with its PAM, plus copies with 1-3 mismatches."""
    g = np.random.default_rng(seed)
    c = gen.make_contig("pl1", n, 6, "PL", g)
    codes = c.codes.copy()
    pam_codes = targets_ref.encode([pam.replace("N", "A")])[0]
    spacers = []
    for at, rev in ((n - L // 2, False), (n - 5, True), (40, False), (n - 100, True),
                    (n // 2, False), (400, True)):
        sp = g.integers(0, 4, L, dtype=np.uint8)
        fwd = targets_ref.revcomp_codes(sp) if rev else sp
        idx = (at + np.arange(L)) % n
        codes[idx] = fwd
        pidx = ((at - len(pam) + np.arange(len(pam))) if rev else (at + L + np.arange(len(pam)))) % n
        codes[pidx] = targets_ref.revcomp_codes(pam_codes) if rev else pam_codes
        spacers.append(sp)
        for k in range(1, 4):
            mut = sp.copy()
            mut[g.choice(L, k, replace=False)] ^= 1
            spacers.append(mut)
    c.codes = codes
    seqs = list(dict.fromkeys(gen.ACGT[s].tobytes().decode() for s in spacers))
    return [c], seqs


@pytest.mark.parametrize("L,pam", [(20, "NGG"), (32, "NGNC")])
@pytest.mark.parametrize("v", [0, 1, 2, 3])
def test_reference_equals_the_program_on_planted_sites(L, pam, v):
    from barcoder_tpu_torch.pipeline.targets import run_targets
    from barcoder_tpu_torch.seqio.library import BarcodeLibrary

    contigs, seqs = planted(4000, L, pam, SEED + v)
    genome = workloads.program_genome(contigs, "Testus")
    table = run_targets(BarcodeLibrary([(f"g{i}", s) for i, s in enumerate(seqs)]), genome,
                        pam, v, backend="torch").table
    want = targets_ref.table_rows(seqs, contigs, pam, "downstream", v)
    got = targets_ref.program_rows(table)
    assert targets_ref.rows_differing(want, got) == 0
    rows = list(want[1])
    col = want[0].index
    assert any(r[col("tar_start")] is not None and r[col("tar_start")] < 0 for r in rows)
    assert {r[col("sp_dir")] for r in rows} >= {"F", "R"}
    assert any(r[col("locus_tag")] is None and r[col("target")] is not None for r in rows)
    assert any(r[col("locus_tag")] == "PL_WRAP" for r in rows)
    if v:
        assert any(r[col("mismatches")] == v for r in rows)


@pytest.mark.parametrize("name", TARGET_CELLS + COUNT_CELLS)
def test_small_run_is_correct_against_the_reference(name):
    r = small_run(name, seconds=1.5)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    first = next(iter(r["checks"].values()))
    assert first["value"] >= 1  # something was checked


def test_count_reference_counts_differences():
    assert count_ref.differing({"a": 1, "b": 2}, {"a": 1, "b": 2}) == 0
    assert count_ref.differing({"a": 1, "b": 2}, {"a": 1, "c": 2}) == 2
    assert count_ref.differing({"a": 1}, {"a": 2}) == 1
