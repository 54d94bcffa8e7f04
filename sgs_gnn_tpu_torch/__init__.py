"""PyTorch + CUDA port of sgs_gnn_tpu for NVIDIA Hopper (H100).

Same subpackages and names as the JAX package, which stays the reference.
The port imports torch, numpy and scipy and nothing of JAX or of
``sgs_gnn_tpu``. Entry points default to ``device="cuda"`` and raise when
no card is present; pass ``device="cpu"`` to run the plain PyTorch versions
of the kernels. Kernels under ``csrc/`` are built at first use on a card
(``ops/_build.py``).
"""
from .core import Config, Graph
from .models import get_model, params_from_jax
from .run import make_predictor, make_sparsifier

__all__ = ["Config", "Graph", "get_model", "params_from_jax",
           "make_sparsifier", "make_predictor"]
