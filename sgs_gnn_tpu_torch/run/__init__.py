from .cli import config_from_args, main
from .driver import RunResult, prepare_batches, run_experiment
from .serve import SparsifiedGraph, make_predictor, make_sparsifier

__all__ = ["run_experiment", "prepare_batches", "RunResult", "main",
           "config_from_args", "SparsifiedGraph", "make_predictor",
           "make_sparsifier"]
