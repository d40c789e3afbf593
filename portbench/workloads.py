"""What the benchmark's traffic drivers share. A traffic mix is a data file,
``traffic/<name>.json``, whose ``kind`` names the driver that serves it,
``drivers/<kind>.py``, and whose other keys are that driver's parameters; a
cell is a configuration under a mix, on the cards its ``chips`` gives.

A driver module defines ``Driver(config, mix, seed, device, chips)`` with
``unit`` (what one timed call serves: ``request`` or ``sample``), ``other``
(the name of the host's time outside the program's phases, for the trace),
``chips`` (the card counts it runs on) and the methods ``setup()``,
``prepare(i)``, ``serve(item, spans)``, ``record(i, item, result,
counters)``, ``release()`` and ``check(control)``; ``close()`` is optional.
Each driver makes its inputs from the seed, warms the program up, prepares
each request outside the request clock, serves it through the program's
in-process entry point inside the clock, and after the window holds what the
program answered against the plain reference.

The program is imported inside the drivers' methods and the helpers here,
nowhere else in the benchmark."""

from __future__ import annotations


def backend(mix: dict, device: str) -> str:
    """The program's scan backend that the mix names; the CPU tests
    (``device="cpu"``) run the program's plain torch path in its place."""
    return mix["backend"] if device == "cuda" else "torch"


def program_genome(contigs: list, organism: str):
    """The program's Genome of the generator's contigs, through its own
    GenBank record types."""
    from barcoder_tpu_torch.core.genome import Genome, contig_from_record
    from barcoder_tpu_torch.seqio.genbank import (
        CompoundLocation, Feature, GenBankRecord, Location,
    )

    out = []
    for c in contigs:
        rec = GenBankRecord(id=c.id, name=c.id.split(".")[0], description=organism,
                            seq=c.ascii(), topology="circular" if c.circular else "linear",
                            organism=organism)
        for g in c.genes:
            loc = (CompoundLocation([Location(g.start, c.length, g.strand),
                                     Location(0, g.end, g.strand)])
                   if g.wraps else Location(g.start, g.end, g.strand))
            rec.features.append(Feature("gene", loc, {"locus_tag": [g.locus_tag],
                                                      "gene": [g.gene] if g.gene else []}))
        out.append(contig_from_record(rec))
    return Genome(out, source="portbench")
