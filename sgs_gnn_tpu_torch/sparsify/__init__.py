from .sampling import sample_edges, sample_prior_edges

__all__ = ["sample_edges", "sample_prior_edges"]
