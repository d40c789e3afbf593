"""count.host_ms_per_mread: the samples' walls less the card's time above,
per million reads: discovery, parsing, windows and key packing on the host."""


def read(run):
    reads = sum(it.work["reads"] for it in run.items) if run.unit == "sample" else 0
    if not reads:
        return None
    host_ms = sum(1e3 * it.wall_s - it.work["card_ms"] for it in run.items)
    return 1e6 * host_ms / reads
