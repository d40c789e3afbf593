"""The plain reference that decides ``correct``: numpy and plain torch,
written from the semantics the configurations state. It imports nothing of
the program and takes nothing the program made: it works the PAM sites, the
hits, the coordinates and the gene join out again from the generator's raw
sequences and gene lists."""
