"""scan.phase2_ms: the program's ``scan.phase2`` spans per request, in ms:
phase 2 of the scan engine: its batches re-scoring the pairs, the fetch and
decode of the hits and the Hits' assembly. Read from the program's span
recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "scan.phase2")
