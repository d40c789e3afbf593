"""Hit arrays — the engine's native output (replacing the reference's SAM
stream from Bowtie, targets.py:310-464)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

STRAND_F = 0
STRAND_R = 1


@dataclass
class Hits:
    """Structure-of-arrays hit table for one contig scan.

    pos is the canonical start of the matched window on the forward genome
    axis, 0 <= pos < contig.length (origin-wrapping hits keep their start
    below length; the reported tar_start/tar_end fold happens in the
    pipeline).
    """

    spacer_idx: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    pos: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    strand: np.ndarray = field(default_factory=lambda: np.empty(0, np.int8))
    mismatches: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))

    def __len__(self) -> int:
        return len(self.pos)

    @staticmethod
    def concat(parts: list["Hits"]) -> "Hits":
        parts = [p for p in parts if len(p)]
        if not parts:
            return Hits()
        return Hits(
            spacer_idx=np.concatenate([p.spacer_idx for p in parts]),
            pos=np.concatenate([p.pos for p in parts]),
            strand=np.concatenate([p.strand for p in parts]),
            mismatches=np.concatenate([p.mismatches for p in parts]),
        )

    def sorted(self) -> "Hits":
        order = np.lexsort((self.strand, self.pos, self.spacer_idx))
        return Hits(
            self.spacer_idx[order], self.pos[order], self.strand[order], self.mismatches[order]
        )
