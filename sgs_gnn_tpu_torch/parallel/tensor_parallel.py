"""Hidden-dimension tensor parallelism (port of
``parallel/tensor_parallel.py``).

The hidden width is split over the ``model`` axis of a two-axis mesh
(``mesh.make_dp_tp_mesh``), Megatron-style. JAX annotates the parameter
shardings and lets GSPMD insert the collectives; here every rank holds its
slice of each owned parameter, and the collectives are explicit autograd
pairs over ``mesh.model_group`` that ``shard_params_tp`` installs on the
modules (a ``tp`` attribute, read by ``models.layers.linear``, the
backbones' and scorers' dropout and the score head):

  (a) into a column-sharded layer: identity forward, all-reduce of the
      input's gradient backward (``copy_in``);
  (b) out of a row-sharded product: the partial products summed over the
      group in f32 forward, then cast to the layer's dtype, the row
      layer's bias added after; identity backward (``reduce``);
  (c) a column-sharded output that feeds anything but its row pair: an
      all-gather over features forward, this rank's slice of the gradient
      backward (``gather``).

Layer pairing (JAX's sets ``_COL``/``_ROW``; a parameter belongs to the
last layer on its path named in either):

  column-sharded: backbone gcn1, scorer gcn1 / fcdim / lin_l / lin_r,
      head fc1, GIN mlp_lin1 (weight (out, in) split on dim 0, the bias
      with it);
  row-sharded: backbone gcn2, scorer gcn2, head fc2, GIN mlp_lin2 (weight
      split on dim 1, the bias whole).

Between a column layer and its row pair (ReLU, dropout, degree scaling,
the segment aggregations K1 and K2) everything is per feature column, so
the activations stay sharded. GCNConv's reduce sits right after its
projection, before the aggregation, so the self-loop term and the bias
see whole rows. The MLP and GraphSAGE scorers have no row pair: (c) comes
before the head. The GAT backbone owns nothing and runs whole on every
rank.

The dropout mask of a column-sharded activation is this rank's slice of
the whole activation's mask, drawn from a generator seeded alike on the
model group's ranks (``mesh.rank_seed`` takes only the data rank), so a
sharded step draws what the unsharded one draws. The score head of a
sharded model runs its unfused route (``models/scorers.py``): the fused
kernels K3-K6 apply the sigmoid inside the kernel, after which a
row-sharded fc2's partial logits can no longer be summed. JAX turns its
Pallas routes off for the same reason (its ``core/fastpath.py``); here the
sharded head picks the route itself, and ``score_tiles`` on it raises, so
the caller builds the graph without a tile index. Build the
``DualOptimizer`` after ``shard_params_tp``, so its state has the shards'
shapes; train step by step (``make_train_step`` or
``make_parallel_train_step``: the graphed epoch refuses a sharded model).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

# layer names whose weight is column-sharded (output dim = nhid)
_COL = {"gcn1", "fcdim", "fc1", "mlp_lin1", "lin_l", "lin_r"}
# layer names whose weight is row-sharded (input dim = nhid)
_ROW = {"gcn2", "fc2", "mlp_lin2"}


def _owner(names: Iterable[str]) -> Optional[str]:
    for n in reversed(list(names)):
        if n in _COL or n in _ROW:
            return n
    return None


def tp_param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dim of the parameter ``name`` (a state-dict name) split over the
    model axis, None when it stays whole. A ``Linear.weight`` is the
    transpose of a flax kernel, so JAX's ``P(None, "model")`` is dim 0
    here and ``P("model", None)`` dim 1."""
    names = name.split(".")
    owner = _owner(names)
    if owner is None:
        return None
    kind = names[-1]
    if kind == "weight" and tensor.dim() == 2:
        return 0 if owner in _COL else 1
    if kind == "bias" and tensor.dim() == 1 and owner in _COL:
        return 0
    return None


class _CopyIn(torch.autograd.Function):
    """(a): identity forward, the gradient summed over the group in f32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _ReduceOut(torch.autograd.Function):
    """(b): the partial products summed over the group in f32; identity
    backward."""

    @staticmethod
    def forward(ctx, partial, group):
        ctx.dtype = partial.dtype
        total = partial.to(torch.float32, copy=True)
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherCols(torch.autograd.Function):
    """(c): the ranks' column blocks concatenated in rank order; backward,
    this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.cols = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.cols
        return g[..., lo:lo + ctx.cols].contiguous(), None, None, None


class Shard:
    """A module's place in the model group: ``col`` (its output features
    are this rank's block, rank ``rank`` of ``size``) or row-sharded (its
    input features are), and the group's collectives (module docstring)."""

    def __init__(self, col: bool, mesh: Mesh):
        self.col = col
        self.group = mesh.model_group
        self.rank, self.size = mesh.model_rank, mesh.tp

    @property
    def cols(self):
        """(rank, size): which block of the whole features this rank holds
        (``ops.dropout``'s ``shard``)."""
        return self.rank, self.size

    def copy_in(self, x):
        return _CopyIn.apply(x, self.group) if x.requires_grad else x

    def reduce(self, partial, dtype):
        return _ReduceOut.apply(partial, self.group).to(dtype)

    def gather(self, x):
        return _GatherCols.apply(x, self.group, self.rank, self.size)


def is_sharded(model: torch.nn.Module) -> bool:
    """True for a model that ``shard_params_tp`` split."""
    return getattr(model, "tp_mesh", None) is not None


def shard_params_tp(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Split ``model``'s owned parameters over ``mesh``'s model axis in
    place: each becomes this rank's slice (``tp_param_spec``), the modules
    get their collectives (``Shard``), and the model is marked sharded.
    Every hidden-sized dim must divide by tp (``ValueError`` otherwise,
    before anything changes). Returns ``model``; build its optimizer after
    this call."""
    if is_sharded(model):
        raise ValueError("shard_params_tp: the model is sharded already")
    tp, r = mesh.tp, mesh.model_rank
    specs = {n: tp_param_spec(n, p) for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        dim = specs[n]
        if dim is not None and p.shape[dim] % tp != 0:
            raise ValueError(f"param {n.replace('.', '/')} dim {dim} size "
                             f"{p.shape[dim]} not divisible by tp={tp}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            dim = specs[n]
            if dim is not None:
                k = p.shape[dim] // tp
                p.data = p.data.narrow(dim, r * k, k).clone()
                p.grad = None
    for name, module in model.named_modules():
        owner = _owner(name.split("."))
        if owner is not None and any(
                specs[f"{name}.{n}"] is not None
                for n, _ in module.named_parameters()):
            module.tp = Shard(owner in _COL, mesh)
    model.tp_mesh = mesh
    return model


def gather_params_tp(model: torch.nn.Module, mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """The whole state dict of a sharded ``model``: each sharded parameter
    all-gathered over the model group (a collective: every rank of the
    group calls it), the others as they are; detached copies."""
    out = {}
    for n, t in model.state_dict().items():
        dim = tp_param_spec(n, t)
        t = t.detach()
        if dim is not None:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(mesh.tp)]
            dist.all_gather(parts, t, group=mesh.model_group)
            t = torch.cat(parts, dim=dim)
        out[n] = t.clone()
    return out
