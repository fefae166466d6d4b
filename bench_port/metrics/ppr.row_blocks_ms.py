"""Per query: the port's span ``slt.csr.row_blocks`` (the build of
``csr_spmv``'s row blocks of P^T at its first product, the download of
indptr and the upload of the blocks included).  See
``bench_port/program.py``."""
from bench_port import program


def read(run):
    return program.total_ms(run, "slt.csr.row_blocks")
