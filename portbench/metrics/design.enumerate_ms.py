"""design.enumerate_ms: the program's ``design.enumerate`` spans per request,
in ms: the design's candidate enumeration, the optional FASTA and the
library build. Read from the program's span recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "design.enumerate")
