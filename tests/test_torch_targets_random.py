"""The port's ``run_targets`` held against the JAX package's on seeded
random inputs: one to three contigs (circular or linear, now and then two
under one id), extra genes with shared, missing or strandless
annotations, planted guides with and without their PAM and mismatched
copies, non-targeting spacers, one or two spacer lengths, identity-named,
named and twice-named libraries, five PAMs, ``gene_window``,
``insert_site``, ``compat_columns`` and ``max_sites``.

Every comparison is exact: frames with dtypes and index classes, the
None / NaN in each object column, the stats and the TSV / JSON text.
"""

import io

import numpy as np
import pandas as pd
import pytest
import torch

from barcoder_tpu.pipeline.targets import run_targets as ref_run_targets
from barcoder_tpu.pipeline.targets import write_output as ref_write_output
from barcoder_tpu.seqio.genbank import Feature, Location
from barcoder_tpu.seqio.library import BarcodeLibrary
from barcoder_tpu_torch.pipeline import targets as port_targets

from .genomes import genome_from_records, make_record, plant_guide, random_seq
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)

PAMS = [("NGG", "downstream"), ("TTTN", "upstream"), ("NN", "downstream"),
        ("NGNC", "downstream"), ("N", "downstream")]


def mutate(seq: str, k: int, rng: np.random.Generator) -> str:
    s = list(seq)
    for p in rng.choice(len(s), size=k, replace=False):
        s[p] = "ACGT"[("ACGT".index(s[p]) + 1 + rng.integers(3)) % 4] if s[p] in "ACGT" else "A"
    return "".join(s)


def random_case(seed: int):
    """(library, genome, run_targets keywords) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    records = []
    for ci in range(int(rng.integers(1, 4))):
        n = int(rng.integers(300, 6_000))
        rec_id = "C0.1" if ci > 0 and rng.random() < 0.4 else f"C{ci}.1"
        rec = make_record(n=n, topology="circular" if rng.random() < 0.7 else "linear",
                          seed=int(rng.integers(1 << 30)), n_genes=int(rng.integers(1, 12)),
                          rec_id=rec_id, wrapped_gene=bool(rng.random() < 0.5))
        if rng.random() < 0.1:
            rec.features = []
        for _ in range(int(rng.integers(0, 6))):
            s = int(rng.integers(0, n - 50))
            e = min(n, s + int(rng.integers(30, 400)))
            kind = int(rng.integers(5))
            q = {"locus_tag": [f"X{int(rng.integers(3))}"]} if kind != 3 else {}
            if rng.random() < 0.5:
                q["gene"] = [f"g{int(rng.integers(3))}"]
            strand = [1, -1, None][int(rng.integers(3))] if kind == 4 else int(rng.choice([1, -1]))
            rec.features.append(Feature("gene", Location(s, e, strand), q))
            if kind == 1:  # the same gene twice
                rec.features.append(Feature("gene", Location(s, e, strand), dict(q)))
            if kind == 2:  # the same tag and start, another end
                rec.features.append(Feature("gene", Location(s, min(n, e + 7), strand), dict(q)))
        records.append(rec)
    pam, direction = PAMS[int(rng.integers(len(PAMS)))]
    lengths = [20] if rng.random() < 0.6 else [20, 24]
    guides = []
    for _ in range(int(rng.integers(0, 40))):
        L = int(rng.choice(lengths))
        rec = records[int(rng.integers(len(records)))]
        n = len(rec.seq)
        if n < L + 10:
            continue
        strand = "F" if rng.random() < 0.5 else "R"
        g = random_seq(L, rng)
        site_pam = "".join(c if c != "N" else "ACGT"[int(rng.integers(4))] for c in pam)
        plant_guide(rec, g, int(rng.integers(0, n)), pam=site_pam if rng.random() < 0.85 else "",
                    strand=strand, pam_direction=direction)
        guides.append(g)
        if rng.random() < 0.3:
            plant_guide(rec, mutate(g, int(rng.integers(1, 4)), rng), int(rng.integers(0, n)),
                        pam=site_pam, strand=strand, pam_direction=direction)
    guides += [random_seq(int(rng.choice(lengths)), rng) for _ in range(int(rng.integers(0, 5)))]
    mode = int(rng.integers(4))  # named, identity, a sequence under two names, a name twice
    entries = []
    for i, g in enumerate(guides):
        q = mutate(g, 1, rng) if rng.random() < 0.2 else g
        if rng.random() < 0.1:
            q = q[:5] + "N" + q[6:]
        if mode == 1:
            entries.append((q, q))
            continue
        entries.append((f"n{i}", q))
        if mode >= 2 and rng.random() < 0.3:
            entries.append((f"n{i}b", q))
        if mode == 3 and rng.random() < 0.3:
            entries.append((f"n{i}", q))
    if mode == 1 and entries and rng.random() < 0.5:
        lib = BarcodeLibrary.from_unique_list(list(dict.fromkeys(q for q, _ in entries)))
    else:
        lib = BarcodeLibrary(entries)
    kw = dict(pam=pam, mismatches=int(rng.integers(0, 4)), pam_direction=direction)
    if rng.random() < 0.3:
        kw["gene_window"] = "upstream"
    if rng.random() < 0.3:
        kw["insert_site"] = True
        if rng.random() < 0.5:
            kw["compat_columns"] = True
    if rng.random() < 0.2:
        kw["max_sites"] = int(rng.integers(1, 3))
    return lib, genome_from_records(records), kw


def assert_frames_identical(got: pd.DataFrame, want: pd.DataFrame) -> None:
    pd.testing.assert_frame_equal(got, want, check_exact=True, check_index_type=True)
    assert type(got.index) is type(want.index)
    for c in got.columns:
        if got[c].dtype == object:
            for x, y in zip(got[c].to_numpy(), want[c].to_numpy()):
                assert type(x) is type(y), (c, x, y)


@pytest.mark.parametrize("seed", range(48))
def test_run_targets_equal_on_random_inputs(seed):
    lib, genome, kw = random_case(seed)
    want = ref_run_targets(lib, genome, backend="jax", **kw)
    got = port_targets.run_targets(lib, genome, backend="torch", **kw)
    assert_frames_identical(got.table, want.table)
    assert_frames_identical(got.results, want.results)
    strip = lambda s: {k: v for k, v in s.items() if k != "profile"}  # noqa: E731
    assert strip(got.stats) == strip(want.stats)
    for as_json in (False, True):
        a, b = io.StringIO(), io.StringIO()
        port_targets.write_output(got, a, as_json=as_json)
        ref_write_output(want, b, as_json=as_json)
        assert a.getvalue() == b.getvalue()
    counters = got.stats["profile"]["counters"]
    assert counters["rows_buffered"] + counters["rows_per_row_strings"] == len(got.results)
