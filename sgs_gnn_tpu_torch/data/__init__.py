from .registry import get_dataset, HostDataset
from .partition import partition_nodes, induced_subgraphs
from .priors import degree_prior, er_prior, effective_resistance_exact, \
    effective_resistance_rw
from .synthetic import (sbm_graph, moon_graph, karate_club,
                        rewire_to_homophily, reddit_style_subsample,
                        community_sbm_graph,
                        community_sbm_low_graph)
from .transforms import (to_undirected, adj_svd_features,
                         train_val_test_masks, edge_homophily,
                         node_homophily, assortativity)

__all__ = [
    "get_dataset", "HostDataset", "partition_nodes", "induced_subgraphs",
    "degree_prior", "er_prior", "effective_resistance_exact",
    "effective_resistance_rw", "sbm_graph", "moon_graph", "karate_club",
    "rewire_to_homophily", "reddit_style_subsample", "community_sbm_graph",
    "community_sbm_low_graph", "to_undirected", "adj_svd_features",
    "train_val_test_masks", "edge_homophily", "node_homophily",
    "assortativity",
]
