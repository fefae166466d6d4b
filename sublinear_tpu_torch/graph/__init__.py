"""The graph layer of the port, with the exports of
``sublinear_tpu/graph/__init__.py``."""
from .centrality import betweenness_centrality, closeness_centrality, compute_centralities
from .community import detect_communities, label_propagation, modularity
from .flow import electrical_network, max_flow, min_cost_flow, weighted_laplacian
from .pagerank import PageRankResult, pagerank, pagerank_statistics, personalized_pagerank
from .resistance import effective_resistance, grounded_laplacian
from .social import degroot_consensus, friedkin_johnsen, influence_propagation

__all__ = [
    "PageRankResult",
    "pagerank",
    "pagerank_statistics",
    "personalized_pagerank",
    "effective_resistance",
    "grounded_laplacian",
    "compute_centralities",
    "closeness_centrality",
    "betweenness_centrality",
    "detect_communities",
    "label_propagation",
    "modularity",
    "electrical_network",
    "max_flow",
    "min_cost_flow",
    "weighted_laplacian",
    "friedkin_johnsen",
    "degroot_consensus",
    "influence_propagation",
]
