"""design.filter_ms: the program's ``design.filter`` spans per request, in ms:
the design's selection filters. Read from the program's span recorder
(``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "design.filter")
