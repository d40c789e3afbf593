"""count.read_ms_per_mread: the program's ``count.read`` spans over the window,
in ms per million reads counted: each chunk's read from the FASTQ file (the
parse into byte matrices). Read from the program's span recorder
(``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_mread(run, "count.read")
