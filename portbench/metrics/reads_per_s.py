"""reads_per_s: every read counted in the window over the sum of the
samples' walls, discovery included."""


def read(run):
    if run.unit != "sample" or not run.items:
        return None
    return sum(it.work["reads"] for it in run.items) / sum(it.wall_s for it in run.items)
