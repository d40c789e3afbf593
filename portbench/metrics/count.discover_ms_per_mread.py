"""count.discover_ms_per_mread: the program's ``count.discover`` spans over the
window, in ms per million reads counted: the sample's discovery (the reads
sampled, the orientation and offset voted, the flanks found). Read from the
program's span recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_mread(run, "count.discover")
