"""Each architecture's plain reference and frozen count, in a module of its
own, found by the configuration's own flags:

  * ``backbone_<GNN>.py``: ``forward(m, x, s, r, w, n, gen)``, the
    backbone's logits on the edges (s, r) weighted by ``w`` (None:
    unweighted), ``gen`` its dropout's generator (None: evaluation); and
    ``count(cfg, n, e)``, its (forward, backward) operations on e edges;
  * ``scorer_<edge_mlp_type>.py``: ``encode(m, x, s, r, n, gen)``, the
    scorer's node embeddings (``reference.Model.encode`` rounds them to
    the compute dtype), and ``count(cfg, n, e)``, the encoder's (forward,
    backward) operations.

``m`` is the reference's ``Model``: its parameters ``P`` by the program's
names, its rounding ``pr``, its dropout rate ``rate``. The layers are
``benchmark/reference.py``'s and their counts ``benchmark/counts.py``'s.
A configuration whose module is missing raises, naming the file to add.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

DIR = Path(__file__).resolve().parent
_loaded = {}


def _load(kind, name):
    path = DIR / f"{kind}_{name}.py"
    mod = _loaded.get(path)
    if mod is None:
        if not path.exists():
            raise NotImplementedError(
                f"no plain reference or count for the {kind} {name!r}: "
                f"add benchmark/archs/{path.name}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_arch_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return mod


def backbone(cfg):
    """The module of the configuration's backbone (``GNN``)."""
    return _load("backbone", cfg["GNN"])


def scorer(cfg):
    """The module of the configuration's scorer (``edge_mlp_type``)."""
    return _load("scorer", cfg["edge_mlp_type"])
