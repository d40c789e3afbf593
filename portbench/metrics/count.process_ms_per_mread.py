"""count.process_ms_per_mread: the program's ``count.process`` spans over the
window, in ms per million reads counted: each chunk's processing: windows,
flank checks, key packing and the hand-off of its keys to the card. Read
from the program's span recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_mread(run, "count.process")
