"""Traffic kind ``count``: ``run_count`` over whole samples, one client in
a closed loop, on one card."""

from __future__ import annotations

import os
import shutil
import tempfile

from portbench import gen
from portbench.reference import count_ref


class Driver:
    """The samples are made in set-up, written as FASTQ under the run's
    temporary directory, and served in turn through ``run_count`` with the
    mix's ``engine``."""

    unit = "sample"
    other = "count"
    chips = (1,)

    def __init__(self, config: dict, mix: dict, seed: int, device: str, chips: int):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        # the CPU tests match on the CPU with the counter the card would use
        self.engine = (dict(engine=mix["engine"]) if device == "cuda"
                       else dict(engine="device", device="cpu"))
        self.results = []  # (sample index, doc, undoc, total)

    def setup(self) -> None:
        mix = self.mix
        self.dir = tempfile.mkdtemp(prefix="portbench-count-")
        lib, undoc = gen.count_library(self.config, self.seed, mix["undocumented_pool"])
        weight = gen.rng(self.seed, "reads", 1).lognormal(0.0, mix["abundance_sigma"], len(lib))
        self.lib_path = os.path.join(self.dir, "library.fasta")
        with open(self.lib_path, "w") as fh:
            fh.write("".join(f">bc{i}\n{s}\n" for i, s in enumerate(lib)))
        self.samples, self.paths = [], []
        for k in range(mix["samples"]):
            s = gen.count_sample(lib, undoc, mix, gen.rng(self.seed, "reads", 2, k), weight)
            path = os.path.join(self.dir, f"sample{k}.fastq")
            gen.write_fastq(path, s.reads)
            s.reads = None
            self.samples.append(s)
            self.paths.append(path)
        for k in range(mix["warmup"]):
            self.serve(k % len(self.paths), None)

    def prepare(self, i: int) -> int:
        return i % len(self.paths)

    def serve(self, k: int, spans):
        from barcoder_tpu_torch.pipeline.heuristic_count import CudaCounter, run_count

        before = getattr(CudaCounter, "device_ms", 0.0)
        doc, undoc, total, info = run_count(self.lib_path, self.paths[k], **self.engine)
        return doc, undoc, total, getattr(CudaCounter, "device_ms", 0.0) - before

    def record(self, i: int, k: int, result, counters: dict) -> dict:
        if result is None:
            return dict(reads=0, card_ms=0.0)
        doc, undoc, total, card_ms = result
        self.results.append((k, doc, undoc, total))
        return dict(reads=int(total), card_ms=float(card_ms))

    def release(self) -> None:
        pass

    def check(self, control: bool) -> dict:
        """counts_differing: over every sample counted in the window, the
        barcodes whose documented or undocumented count differs from the
        generator's truth, and each total that differs from the reads
        written. The control counts the reads whose N lies outside the
        barcode too."""
        diff = 0
        for k, doc, undoc, total in self.results:
            s = self.samples[k]
            if control:
                doc, undoc = s.control_doc, s.control_undoc
            diff += count_ref.differing(s.doc, doc) + count_ref.differing(s.undoc, undoc)
            diff += int(total != self.mix["reads"])
        return {"samples_checked": {"value": len(self.results), "at_least": 1},
                "counts_differing": {"value": diff, "at_most": 0}}

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
