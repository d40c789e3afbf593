"""Traffic kind ``design``: ``run_design`` with the default options, one
client in a closed loop, on one card."""

from __future__ import annotations

from portbench import gen, roofline
from portbench.reference import design_ref, targets_ref
from portbench.workloads import backend, program_genome


class Driver:
    """Each request designs a library on a fresh strain variant of the
    configuration's genome (made between requests). The program's phases
    come from the targets stage's own profile (``run_design`` takes no
    collector), so the host's time outside them is the whole ``design``."""

    unit = "request"
    other = "design"
    chips = (1,)

    def __init__(self, config: dict, mix: dict, seed: int, device: str, chips: int):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.backend = backend(mix, device)
        self.L = config["spacer_len"]
        self.pam, self.direction = config["pam"], config["pam_direction"]
        self.kept = {}
        self.first = None

    def setup(self) -> None:
        self.base = gen.make_genome(self.config, self.seed)
        for k in range(self.mix["warmup"]):
            self.serve(self._item(gen.rng(self.seed, "warmup", k)), None)

    def _item(self, g) -> tuple:
        contigs = gen.variant(self.base, self.mix["substitution_rate"], g)
        return program_genome(contigs, self.config["organism"]), contigs

    def prepare(self, i: int) -> tuple:
        return self._item(gen.rng(self.seed, "variant", i))

    def serve(self, item: tuple, spans):
        from barcoder_tpu_torch.pipeline.design import DesignOptions, run_design

        final, tr, candidates = run_design(
            item[0], self.pam, self.L, DesignOptions(pam_direction=self.direction),
            backend=self.backend)
        if spans is not None:
            spans.timings.update(tr.stats["profile"]["timings_s"])
            spans.counters.update(tr.stats["profile"]["counters"])
        return final, len(candidates)

    def record(self, i: int, item: tuple, result, counters: dict) -> dict:
        contigs = item[1]
        if result is None:
            return {"design": True}
        final, n_candidates = result
        n_sites = sum(len(f) + len(r) for f, r in
                      gen.sites(contigs, self.L, self.pam, self.direction))
        work = roofline.scan_work(n_candidates, n_sites, self.L,
                                  sum(c.length for c in contigs), int(counters.get("hits", 0)))
        work["design"] = True
        if gen.rng(self.seed, "check", i).random() < self.mix["check_share"]:
            self.kept[i] = (contigs, final)
        elif self.first is None:
            self.first = (i, (contigs, final))
        return work

    def release(self) -> None:
        pass

    def check(self, control: bool) -> dict:
        """rows_differing: rows of the sampled designs (and of the first)
        that the reference does not select, and rows it selects that they
        lack. The control leaves the reverse strand's hits out."""
        kept = dict(self.kept)
        if self.first is not None and not kept:
            kept.setdefault(*self.first)
        diff = 0
        for contigs, final in kept.values():
            want = design_ref.design_rows(contigs, self.L, self.pam, self.direction,
                                          device=self.device)
            got = (design_ref.design_rows(contigs, self.L, self.pam, self.direction,
                                          device=self.device, reverse=False)
                   if control else targets_ref.program_rows(final))
            diff += targets_ref.rows_differing(want, got)
        return {"requests_checked": {"value": len(kept), "at_least": 1},
                "rows_differing": {"value": diff, "at_most": 0}}
