"""design.offtargets_ms: the program's ``design.offtargets`` spans per request,
in ms: the design filters' off-target step (``omit_offtargets``), which reads
each row's site count from its note and drops the spacers with more than one
site. Read from the program's span recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "design.offtargets")
