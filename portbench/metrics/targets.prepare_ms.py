"""targets.prepare_ms: the program's ``targets.prepare`` spans per request, in
ms: the library bookkeeping before the scan: names by sequence, the sequence
array and lengths, and each length group's spacer matrices. Read from the
program's span recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "targets.prepare")
