"""The port's mismatch-efficacy model and CLI (``barcoder_tpu_torch.model``
and ``cli/mismatch.py``, copies of the JAX package's) held against the JAX
package's on a parameters CSV that the test writes from seeded random
weights (the published weights are reference data this repository does not
ship). Every comparison is EXACT: equal floats, variants and CLI stdout.
"""

import numpy as np
import pytest

import barcoder_tpu.model.mismatch as jmm
import barcoder_tpu_torch.model.mismatch as tmm
from barcoder_tpu.cli.mismatch import main as ref_cli
from barcoder_tpu_torch.cli.mismatch import main as port_cli

from .genomes import random_seq

NT = "ACGT"


@pytest.fixture(scope="module")
def params_csv(tmp_path_factory):
    """feature,weight rows in the published file's layout: an intercept,
    one weight per position 0-19 (the last 0.0), the twelve substitutions
    (TG pinned at 0.0) and the GC content."""
    rng = np.random.default_rng(11)
    rows = [("intercept", rng.normal(0, 0.1))]
    rows += [(str(p), 0.0 if p == 19 else rng.uniform(0, 1)) for p in range(20)]
    rows += [(a + b, 0.0 if a + b == "TG" else rng.uniform(-0.5, 0.5))
             for a in NT for b in NT if a != b]
    rows += [("GC_content", rng.uniform(0, 1))]
    path = tmp_path_factory.mktemp("mm") / "mismatch_parameters.csv"
    path.write_text("feature,weight\n" + "".join(f"{k},{w!r}\n" for k, w in rows))
    return str(path)


@pytest.fixture(scope="module")
def params(params_csv):
    return jmm.MismatchParams.from_csv(params_csv), tmm.MismatchParams.from_csv(params_csv)


def test_params_load_the_same(params):
    want, got = params
    assert got.intercept == want.intercept and got.gc_weight == want.gc_weight
    assert np.array_equal(got.position_weights, want.position_weights)
    assert np.array_equal(got.sub_weights, want.sub_weights)
    assert got.raw == want.raw


def test_y_pred_matches(params):
    want, got = params
    rng = np.random.default_rng(12)
    for _ in range(200):
        original = random_seq(20, rng)
        variant = list(original)
        for p in rng.choice(20, int(rng.integers(0, 4)), replace=False):
            variant[p] = NT[(NT.index(variant[p]) + int(rng.integers(1, 4))) % 4]
        variant = "".join(variant)
        assert tmm.calculate_y_pred(original, variant, got) == jmm.calculate_y_pred(
            original, variant, want)
    for a, b in (("ACGT" * 5, "ACGT" * 5), ("ACGTA", "ACGT"), (None, "A"), ("A", 3)):
        assert tmm.calculate_y_pred(a, b, got) is None
    with pytest.raises(KeyError):
        tmm.calculate_y_pred("A" * 21, "A" * 20 + "C", got)


@pytest.mark.parametrize("L", [12, 20])
def test_single_variant_scores_and_grid_match(params, L):
    want, got = params
    rng = np.random.default_rng(L)
    for _ in range(20):
        spacer = random_seq(L, rng)
        v_got, s_got = tmm.all_single_variant_scores(spacer, got)
        v_want, s_want = jmm.all_single_variant_scores(spacer, want)
        assert v_got == v_want and np.array_equal(s_got, s_want)
        for lo, hi, step in ((0.0, 1.0, 0.1), (-0.5, 2.0, 0.25)):
            chosen = tmm.generate_mismatches(spacer.lower(), lo, hi, step, got)
            assert chosen == jmm.generate_mismatches(spacer.lower(), lo, hi, step, want)
            picked = [v for v, _ in chosen]
            assert len(set(picked)) == len(picked)
        v = v_got[int(rng.integers(len(v_got)))]
        assert tmm.apply_variant(spacer, v) == jmm.apply_variant(spacer, v)
        assert tmm.change_description(spacer, v) == jmm.change_description(spacer, v)
    with pytest.raises(KeyError):
        tmm.all_single_variant_scores("ACGTN" * 2, got)


def test_mismatches_cli_matches(tmp_path, capsys, params_csv):
    rng = np.random.default_rng(13)
    spacers = tmp_path / "spacers.tsv"
    spacers.write_text("target\n" + "".join(random_seq(20, rng) + "\n" for _ in range(6))
                       + "acgtacgtacgtacgtacgt\n")
    argv = ["mismatches", "--spacers_file", str(spacers), "--parameters_file", params_csv,
            "--min", "0", "--max", "1.5", "--step", "0.25"]
    assert ref_cli(argv) == 0
    want = capsys.readouterr().out
    assert port_cli(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    lines = got.splitlines()
    assert lines[0].split("\t") == ["original", "variant", "change_description", "y_pred"]
    assert len(lines) == 1 + 7 * 7


def test_recalculate_cli_matches(tmp_path, capsys, params_csv):
    tsv = tmp_path / "mm.tsv"
    tsv.write_text("target\tspacer\ty_pred\tcount\n"
                   "ACGTACGTACGTACGTACGT\tCCGTACGTACGTACGTACGT\t0.5\t3\n"
                   "ACGTACGTACGTACGTACGT\tACGTACGTACGTACGTACGT\t0.1\t4\n"
                   "acgtacgtacgtacgtacgt\tacgaacgtacgtacgtacgt\t0.2\t5\n")
    argv = ["recalculate", "--existing_mismatches", str(tsv), "--parameters_file", params_csv]
    assert ref_cli(argv) == 0
    want = capsys.readouterr().out
    assert port_cli(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[0].endswith("y_pred_new") and "None" in got


@pytest.mark.parametrize("argv,rc", [
    (["mismatches", "--parameters_file", "{csv}"], 2),
    (["recalculate", "--parameters_file", "{csv}"], 2),
    (["mismatches", "--spacers_file", "{missing}", "--parameters_file", "{csv}"], 1),
    (["mismatches", "--spacers_file", "{bad}", "--parameters_file", "{csv}"], 1),
])
def test_cli_errors_match(tmp_path, capsys, params_csv, argv, rc):
    bad = tmp_path / "bad.tsv"
    bad.write_text("spacer\nACGT\n")
    argv = [a.format(csv=params_csv, missing=tmp_path / "nope.tsv", bad=bad) for a in argv]
    assert ref_cli(argv) == rc
    want = capsys.readouterr().out
    assert port_cli(argv) == rc
    assert capsys.readouterr().out == want == ""
