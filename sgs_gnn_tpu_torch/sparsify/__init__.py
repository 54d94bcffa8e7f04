from .sampling import (edge_sampler, random_edges, sample_edges,
                       sample_prior_edges, temperature_at)

__all__ = ["edge_sampler", "random_edges", "sample_edges",
           "sample_prior_edges", "temperature_at"]
