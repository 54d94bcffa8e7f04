from .serve import SparsifiedGraph, make_predictor, make_sparsifier

__all__ = ["SparsifiedGraph", "make_predictor", "make_sparsifier"]
