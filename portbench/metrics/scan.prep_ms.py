"""scan.prep_ms: the program's ``scan.prep`` spans per request, in ms: the scan
engine's host prep: the library's spacer matrix and device prep (found in
its cache or built), and per contig the engine's choice and its site table
or scan array (found or built and shipped). Read from the program's span
recorder (``portbench.spans``)."""

from portbench import spans


def read(run):
    return spans.ms_per_item(run, "scan.prep")
