"""targets.assemble_ms: the program's ``targets.assemble`` spans per request,
in ms: the unmapped rows, the frames' concat, the name merge and the column
order, between the annotation and postprocess. Read from the program's span
recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "targets.assemble")
