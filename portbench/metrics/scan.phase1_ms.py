"""scan.phase1_ms: the program's ``scan.phase1`` spans per request, in ms:
phase 1 of the scan engine, from its launch until ``torch.nonzero`` has
sized its pairs on the host. Read from the program's span recorder
(``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "scan.phase1")
