from .types import Hits, STRAND_F, STRAND_R
from .scan import scan_contig, scan_contigs, scan_genome, resolve_backend
