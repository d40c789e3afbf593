from .genbank import GenBankRecord, Feature, Location, CompoundLocation, parse_genbank, write_genbank
from .fasta import read_fasta, write_fasta, iter_fastq, write_fastq, iter_read_chunks, read_barcode_fasta, open_seq_file
from .snapgene import parse_snapgene, read_snapgene_dir
from .library import BarcodeLibrary, BarcodeLibraryError
