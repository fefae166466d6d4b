"""Share of the Neumann chains that ran inside a replay of the Neumann solver's
CUDA graphs, over the profiled requests: the port's counters
``neumann_graph_chunks`` and ``neumann_chain_calls``, 100 replayed / all.
None where the port has no ``neumann_graph_chunks`` counter (a port
without the graphs, or one whose graphs never replayed) or ran no chain.
See ``bench_port/program.py``."""
from bench_port import program


def read(run):
    replayed = program.per_request_count(run, "neumann_graph_chunks")
    chains = program.per_request_count(run, "neumann_chain_calls")
    if replayed is None or not chains:
        return None
    return 100.0 * replayed / chains
