"""Traffic kind ``targets``: ``run_targets`` requests of one client in a
closed loop, on one card."""

from __future__ import annotations

from portbench import gen, roofline
from portbench.reference import targets_ref
from portbench.workloads import backend, program_genome


class Driver:
    """``genome`` is ``resident`` (one genome, a fresh library drawn from a
    size deck each request) or ``panel`` (the configuration's fixed library,
    a fresh strain variant of the genome each request); ``backend`` is the
    scan backend the requests name."""

    unit = "request"
    other = "targets.other"  # what the host does outside the program's phases
    chips = (1,)

    def __init__(self, config: dict, mix: dict, seed: int, device: str, chips: int):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.backend = backend(mix, device)
        self.L = config["spacer_len"]
        self.pam, self.direction = config["pam"], config["pam_direction"]
        self.kept = {}  # request index -> (spacers, contigs, v, table)
        self.largest = None

    # -- inputs ---------------------------------------------------------------

    def _sites(self, contigs: list) -> list:
        return gen.sites(contigs, self.L, self.pam, self.direction)

    def _library(self, size: int, g) -> list:
        return gen.site_library(self.base, self.base_sites, self.L, size,
                                self.mix["library"]["site_share"], g)

    def setup(self) -> None:
        self.base = gen.make_genome(self.config, self.seed)
        self.base_sites = self._sites(self.base)
        mix, lib = self.mix, self.mix["library"]
        if mix["genome"] == "resident":
            self.deck = gen.size_deck(lib, mix["mismatches"])
            self.genome = program_genome(self.base, self.config["organism"])
        elif mix["genome"] == "panel":
            self.spacers = self._library(self.config["library_size"], gen.rng(self.seed, "library"))
        else:
            raise ValueError(f"unknown genome mode {mix['genome']!r}")
        v = max(mix["mismatches"])
        for k in range(mix["warmup"]):
            g = gen.rng(self.seed, "warmup", k)
            if mix["genome"] == "resident":
                item = (self._library(max(s for s, _ in self.deck), g), self.genome, None, v)
            else:
                item = self._panel_item(g, v)
            self.serve(item, None)

    def _panel_item(self, g, v: int) -> tuple:
        contigs = gen.variant(self.base, self.mix["substitution_rate"], g)
        return (self.spacers, program_genome(contigs, self.config["organism"]), contigs, v)

    def prepare(self, i: int) -> tuple:
        """Request ``i``: (spacers, program genome, generator contigs, v)."""
        mix = self.mix
        if mix["genome"] == "resident":
            k = len(self.deck)
            order = gen.deck_order(k, self.mix["library"]["strata"],
                                   gen.rng(self.seed, "deck", i // k))
            size, v = self.deck[order[i % k]]
            return (self._library(size, gen.rng(self.seed, "library", i)), self.genome, None, v)
        budgets = mix["mismatches"]
        order = gen.rng(self.seed, "deck", i // len(budgets)).permutation(len(budgets))
        return self._panel_item(gen.rng(self.seed, "variant", i),
                                budgets[order[i % len(budgets)]])

    # -- the timed call -------------------------------------------------------

    def serve(self, item: tuple, spans):
        from barcoder_tpu_torch.pipeline.targets import run_targets
        from barcoder_tpu_torch.seqio.library import BarcodeLibrary

        spacers, genome, _, v = item
        library = BarcodeLibrary([(f"g{k}", s) for k, s in enumerate(spacers)])
        return run_targets(library, genome, self.pam, v, pam_direction=self.direction,
                           backend=self.backend, phases=spans)

    def record(self, i: int, item: tuple, result, counters: dict) -> dict:
        """The request's work, counted from its inputs; keeps the requests
        that the check will compare: a share drawn from the seed, and the
        largest library served."""
        spacers, _, contigs, v = item
        n_sites = sum(len(f) + len(r) for f, r in
                      (self.base_sites if contigs is None else self._sites(contigs)))
        S = len(spacers)
        work = roofline.scan_work(S, n_sites, self.L,
                                  sum(c.length for c in contigs or self.base),
                                  int(counters.get("hits", 0)))
        if result is None:
            return work
        keep = (spacers, contigs or self.base, v, result.table)
        if gen.rng(self.seed, "check", i).random() < self.mix["check_share"]:
            self.kept[i] = keep
        if self.largest is None or S > len(self.largest[1][0]):
            self.largest = (i, keep)
        return work

    def release(self) -> None:
        """Drops the program's resident state before the check."""
        self.genome = None

    def check(self, control: bool) -> dict:
        """rows_differing: rows of the sampled tables (and of the largest
        library's) that the reference does not give, and rows it gives that
        they lack. The control puts the reference with one guarantee broken
        (hits at exactly v mismatches left out) in the program's place."""
        kept = dict(self.kept)
        if self.largest is not None:
            kept.setdefault(*self.largest)
        diff = 0
        for spacers, contigs, v, table in kept.values():
            want = targets_ref.table_rows(spacers, contigs, self.pam, self.direction, v,
                                          self.device)
            got = (targets_ref.table_rows(spacers, contigs, self.pam, self.direction, v - 1,
                                          self.device)
                   if control else targets_ref.program_rows(table))
            diff += targets_ref.rows_differing(want, got)
        return {"requests_checked": {"value": len(kept), "at_least": 1},
                "rows_differing": {"value": diff, "at_most": 0}}
