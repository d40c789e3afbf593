from .encode import encode, decode, revcomp, revcomp_codes, onehot, pack_2bit, gc_content, N_CODE
from .genome import Genome, Contig, LocusEntry, contig_from_record, OVERHANG
from .coords import fold_hit_coords, get_coords, get_offset, get_overlap, get_diff
from .pam import pam_site_masks, extract_pam, pam_matches, pam_is_trivial
from .locus import join_hits_to_loci
