"""Plain reference of a ``count`` sample. The generator knows which barcode
each read carries and which reads hold an N, so its tallies are the truth
(``gen.count_sample``): documented counts by barcode, undocumented ones by
barcode plus ``*``, over the reads without an N. This module compares."""

from __future__ import annotations


def differing(want: dict, got: dict) -> int:
    """Barcodes whose count differs between two tallies (a barcode missing
    from one counts as 0 there)."""
    return sum(1 for k in set(want) | set(got) if want.get(k, 0) != got.get(k, 0))
