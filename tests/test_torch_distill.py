"""The port's ``distill`` (``barcoder_tpu_torch.pipeline.distill``, a partial
copy of the JAX package's without the multi-host half, and its CLI) held
against the JAX package's on the cases of tests/test_distill.py. Every
comparison is EXACT: the port's ``.reads.zst`` outputs, decompressed, are
byte-equal to the JAX package's, and equal to the sorted reads.
"""

import gzip

import numpy as np
import pytest
import zstandard as zstd

import barcoder_tpu.pipeline.distill as jd
import barcoder_tpu_torch.pipeline.distill as td
from barcoder_tpu.cli.distill import main as ref_cli
from barcoder_tpu.seqio.fasta import write_fastq
from barcoder_tpu_torch.cli.distill import main as port_cli

from .genomes import random_seq


def unzst(path) -> bytes:
    with zstd.open(path, "rb") as fh:
        return fh.read()


def write(path, reads, gz=False):
    recs = [(f"r{i}", s) for i, s in enumerate(reads)]
    if gz:
        with gzip.open(path, "wt") as fh:
            write_fastq(recs, fh, quality=30)
    else:
        write_fastq(recs, path, quality=30)
    return str(path)


def run_both(tmp_path, files, **kw):
    """distill through both packages into separate outputs; returns the
    port's decompressed outputs after asserting they equal the JAX one's."""
    outs = {}
    for name, mod in (("jax", jd), ("port", td)):
        extra = dict(kw)
        if "checkpoint_dir" in extra:
            extra["checkpoint_dir"] = str(tmp_path / f"ckpt_{name}")
        paths = [str(tmp_path / f"{name}{i}.reads.zst") for i in range(len(files))]
        assert mod.distill_reads(files, paths, **extra) == paths
        outs[name] = [unzst(p) for p in paths]
    assert outs["port"] == outs["jax"]
    return [o.decode().splitlines() for o in outs["port"]]


@pytest.mark.parametrize("name", ["a.fastq.gz", "a.fastq", "a.reads", "dir/b.fastq"])
def test_output_filename_mapping(name):
    assert td.get_output_filename(name) == jd.get_output_filename(name)


# (read width range, reads, files, chunk size): in memory, one chunk, the
# in-memory merge of several chunks, and the external merge of spilled runs
CASES = {
    "paired_in_memory": ((30, 31), 500, 2, 128),
    "single_one_chunk": ((25, 26), 300, 1, 1 << 20),
    "single_spill": ((15, 16), 400, 1, 3),
    "paired_spill_variable_widths": ((8, 20), 300, 2, 4),
    "three_files_variable_widths": ((5, 12), 200, 3, 50),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_equal_the_jax_packages(tmp_path, case):
    (lo, hi), n, n_files, chunk = CASES[case]
    rng = np.random.default_rng(len(case))
    cols = [[random_seq(int(rng.integers(lo, hi)), rng) for _ in range(n)]
            for _ in range(n_files)]
    files = [write(tmp_path / f"in{i}.fastq", c) for i, c in enumerate(cols)]
    got = run_both(tmp_path, files, chunk_size=chunk)
    want = sorted(zip(*cols))
    assert list(zip(*got)) == want


def test_gz_input_and_cli(tmp_path, capsys):
    rng = np.random.default_rng(1)
    reads = [random_seq(25, rng) for _ in range(300)]
    f1 = write(tmp_path / "x.fastq.gz", reads, gz=True)
    assert ref_cli([f1, "--chunk-size", "100"]) == 0
    want = unzst(tmp_path / "x.reads.zst")
    (tmp_path / "x.reads.zst").unlink()
    assert port_cli([f1, "--chunk-size", "100"]) == 0
    assert unzst(tmp_path / "x.reads.zst") == want
    assert want.decode().splitlines() == sorted(reads)


def test_cli_reports_a_missing_file(tmp_path):
    assert port_cli([str(tmp_path / "nope.fastq")]) == ref_cli([str(tmp_path / "nope.fastq")]) == 1


def test_checkpointed_run_matches(tmp_path):
    rng = np.random.default_rng(7)
    r1 = [random_seq(28, rng) for _ in range(600)]
    r2 = [random_seq(28, rng) for _ in range(600)]
    files = [write(tmp_path / "c1.fastq", r1), write(tmp_path / "c2.fastq", r2)]
    got = run_both(tmp_path, files, chunk_size=100, checkpoint_dir=True)
    assert list(zip(*got)) == sorted(zip(r1, r2))
    assert not (tmp_path / "ckpt_port" / "manifest.json").exists()
    assert not list((tmp_path / "ckpt_port").glob("run*.zst"))


@pytest.mark.parametrize("change_input", [False, True])
def test_checkpoint_crash_resume_matches(tmp_path, monkeypatch, change_input):
    """Kill the port's distill after four spilled chunks; the rerun skips
    them (no re-sort) and writes the JAX package's bytes. With an input
    changed in between, the stale runs are discarded instead."""
    rng = np.random.default_rng(9)
    r1 = [random_seq(28, rng) for _ in range(1000)]
    r2 = [random_seq(28, rng) for _ in range(1000)]
    files = [write(tmp_path / "c1.fastq", r1), write(tmp_path / "c2.fastq", r2)]
    ckpt = tmp_path / "ckpt"
    outs = [str(tmp_path / "o1.zst"), str(tmp_path / "o2.zst")]

    class Boom(Exception):
        pass

    orig_sort = td._sort_chunk
    calls = {"n": 0}

    def crashing(cols):
        calls["n"] += 1
        if calls["n"] > 4:
            raise Boom()
        return orig_sort(cols)

    monkeypatch.setattr(td, "_sort_chunk", crashing)
    with pytest.raises(Boom):
        td.distill_reads(files, outs, chunk_size=100, checkpoint_dir=str(ckpt))
    assert (ckpt / "manifest.json").exists()
    assert len(list(ckpt.glob("run*.zst"))) == 4
    if change_input:
        r1 = [random_seq(28, rng) for _ in range(1000)]
        write(tmp_path / "c1.fastq", r1)
    resorted = {"n": 0}

    def counting(cols):
        resorted["n"] += 1
        return orig_sort(cols)

    monkeypatch.setattr(td, "_sort_chunk", counting)
    td.distill_reads(files, outs, chunk_size=100, checkpoint_dir=str(ckpt))
    assert resorted["n"] == (10 if change_input else 10 - 4)
    want = [str(tmp_path / "w1.zst"), str(tmp_path / "w2.zst")]
    jd.distill_reads(files, want, chunk_size=100)
    assert [unzst(p) for p in outs] == [unzst(p) for p in want]
    assert [unzst(p).decode().splitlines() for p in outs] == [list(c) for c in
                                                              zip(*sorted(zip(r1, r2)))]
    assert not (ckpt / "manifest.json").exists()
