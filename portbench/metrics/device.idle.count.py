"""device.idle.count: the share of the samples' walls in which no operation ran
on the device, in %: 1 minus the device's busy union inside the samples over
their summed walls."""


def read(run):
    if run.unit != "sample" or not run.items or any(it.busy_s is None for it in run.items):
        return None
    return 100.0 * (1.0 - sum(it.busy_s for it in run.items) / sum(it.wall_s for it in run.items))
