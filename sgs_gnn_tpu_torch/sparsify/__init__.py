from .sampling import (random_edges, sample_edges, sample_prior_edges,
                       temperature_at)

__all__ = ["random_edges", "sample_edges", "sample_prior_edges",
           "temperature_at"]
