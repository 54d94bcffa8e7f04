from .priors import degree_prior

__all__ = ["degree_prior"]
