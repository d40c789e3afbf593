"""Traffic kind ``design_offtargets``: the ``design`` kind's closed loop with
``omit_offtargets``, on a configuration generated with its GC share and
planted repeats (``portbench.gen_repeats``), checked against the reference
with the off-target step."""

from __future__ import annotations

import time

from portbench import gen, gen_repeats
from portbench.drivers import design
from portbench.harness import log
from portbench.reference import design_offtargets_ref, targets_ref

COUNTERS = ("design.candidates", "design.multisite_spacers",
            "design.offtarget_spacers_removed", "scan.pairs", "hits")


class Driver(design.Driver):
    """As ``design.Driver``; each request also keeps the program's count of
    the spacers its off-target step removed, for the check."""

    def __init__(self, *args):
        super().__init__(*args)
        self.removed = {}  # request -> design.offtarget_spacers_removed

    def setup(self) -> None:
        self.base = gen_repeats.make_genome(self.config, self.seed)
        for k in range(self.mix["warmup"]):
            self.serve(self._item(gen.rng(self.seed, "warmup", k)), None)

    def serve(self, item: tuple, spans):
        from barcoder_tpu_torch.pipeline.design import DesignOptions, run_design

        final, tr, candidates = run_design(
            item[0], self.pam, self.L,
            DesignOptions(pam_direction=self.direction,
                          omit_offtargets=self.mix["omit_offtargets"]),
            backend=self.backend)
        if spans is not None:
            spans.timings.update(tr.stats["profile"]["timings_s"])
            spans.counters.update(tr.stats["profile"]["counters"])
        return final, len(candidates)

    def record(self, i: int, item: tuple, result, counters: dict) -> dict:
        work = super().record(i, item, result, counters)
        if result is not None:
            self.removed[i] = int(counters["design.offtarget_spacers_removed"])
            log(f"request {i} counters { {k: counters[k] for k in COUNTERS if k in counters} }")
        return work

    def check(self, control: bool) -> dict:
        """rows_differing: rows of the sampled designs (and of the first)
        that the reference does not select, and rows it selects that they
        lack; offtarget_spacers_differing: the spacers the program's
        off-target step removed, less the reference's count, in absolute
        value. The control leaves the off-target step out."""
        kept = dict(self.kept)
        if self.first is not None and not kept:
            kept.setdefault(*self.first)
        diff = removed_diff = 0
        for i, (contigs, final) in kept.items():
            t0 = time.perf_counter()
            table = design_offtargets_ref.mapped(contigs, self.L, self.pam, self.direction,
                                                 device=self.device)
            t1 = time.perf_counter()
            *want, want_removed = design_offtargets_ref.design_rows(table, self.L)
            removed = self.removed[i]
            if control:
                *got, removed = design_offtargets_ref.design_rows(table, self.L,
                                                                  offtargets=False)
            else:
                got = targets_ref.program_rows(final)
            log(f"reference removed {want_removed} spacers, selected "
                f"{sum(want[1].values())} rows; mapped in {t1 - t0:.1f} s, selected and "
                f"compared in {time.perf_counter() - t1:.1f} s")
            diff += targets_ref.rows_differing(tuple(want), tuple(got))
            removed_diff += abs(removed - want_removed)
        return {"requests_checked": {"value": len(kept), "at_least": 1},
                "rows_differing": {"value": diff, "at_most": 0},
                "offtarget_spacers_differing": {"value": removed_diff, "at_most": 0}}
