"""Faults planted in the program, to show that the comparison catches
them (``benchmark/tests/test_bench_faults.py`` on the CPU,
``benchmark/readings.py --fault`` on the card). Each is a context manager
that patches the port while it is open; graphs captured meanwhile keep
the fault.

  state_unchanged  the optimizer computes its update and applies none;
  half_batch       the loss is the mean over every other train node;
  loss_altered     the step's loss comes out 2 % high;
  winners_altered  a tenth of the learned step's q winners move to the
                   next tile slot;
  half_draws       serving averages half of the configured draws;
  answer_altered   the backbone's logits of one node are moved by 1;
  eval_skipped     the eval runs every other partition;
  eval_altered     the eval's logits of every tenth node are rolled by one
                   class before they are scored;
  node_dropped     the partition leaves one node outside every part.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def state_unchanged():
    from sgs_gnn_tpu_torch.train import optim
    return _patched(optim.DualOptimizer, "_apply",
                    lambda orig: lambda self, *updates: None)


def half_batch():
    from sgs_gnn_tpu_torch.train import pipelines

    def make(orig):
        def ce(logits, labels, mask):
            keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
            return orig(logits, labels, mask & keep)
        return ce
    return _patched(pipelines, "masked_cross_entropy", make)


def loss_altered():
    from sgs_gnn_tpu_torch.train import pipelines
    return _patched(pipelines, "masked_cross_entropy",
                    lambda orig: lambda *a: orig(*a) * 1.02)


def winners_altered():
    from sgs_gnn_tpu_torch.train import pipelines

    def make(orig):
        def sample_edges(generator, edge_probs, prior, q, *args, **kwargs):
            idx, w = orig(generator, edge_probs, prior, q, *args, **kwargs)
            k = max(1, q // 10)
            moved = (idx[:k].long() + 1) % edge_probs.shape[0]
            return torch.cat([moved.to(idx.dtype), idx[k:]]), w
        return sample_edges
    return _patched(pipelines, "sample_edges", make)


def half_draws():
    from sgs_gnn_tpu_torch.run import serve

    def make(orig):
        def make_predictor(cfg, model, q):
            return orig(cfg.replace(
                num_samples_eval=max(1, cfg.num_samples_eval // 2)), model,
                q)
        return make_predictor
    return _patched(serve, "make_predictor", make)


def answer_altered():
    from sgs_gnn_tpu_torch.models import backbones

    def make(orig):
        def forward(self, x, *args, **kwargs):
            out = orig(self, x, *args, **kwargs)
            bump = torch.zeros_like(out)
            bump[0] = 1.0
            return out + bump
        return forward
    return _patched(backbones._Backbone, "forward", make)


def eval_skipped():
    from sgs_gnn_tpu_torch.eval import evaluate

    def make(orig):
        def call(self, batches, small_flags, *args):
            return orig(self, batches[::2], small_flags[::2], *args)
        return call
    return _patched(evaluate.ScanEvalStep, "__call__", make)


def eval_altered():
    from sgs_gnn_tpu_torch.eval import evaluate

    def make(orig):
        def micro_f1(logits, labels, mask):
            moved = logits.clone()
            moved[::10] = logits[::10].roll(1, -1)
            return orig(moved, labels, mask)
        return micro_f1
    return _patched(evaluate, "micro_f1", make)


def node_dropped():
    from sgs_gnn_tpu_torch.run import driver

    def make(orig):
        def partition_nodes(edge_index, num_nodes, num_parts, **kwargs):
            part = orig(edge_index, num_nodes, num_parts, **kwargs)
            part[0] = num_parts
            return part
        return partition_nodes
    return _patched(driver, "partition_nodes", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "loss_altered": loss_altered, "winners_altered": winners_altered,
          "half_draws": half_draws, "answer_altered": answer_altered,
          "eval_skipped": eval_skipped, "eval_altered": eval_altered,
          "node_dropped": node_dropped}
# per cell, the faults its compared numbers catch on the card (PERF.md
# gives the readings)
TRAIN_CAUGHT = ("state_unchanged", "half_batch", "eval_altered",
                "eval_skipped", "node_dropped")
CAUGHT = {
    "gcn_reddit.train_learned": TRAIN_CAUGHT + ("loss_altered",
                                                "winners_altered"),
    "gat_gsage_reddit.train_learned": TRAIN_CAUGHT + ("loss_altered",
                                                      "winners_altered"),
    "gcn_reddit.train_random": TRAIN_CAUGHT + ("loss_altered",),
    "gcn_reddit.serve_predict": ("half_draws", "answer_altered",
                                 "node_dropped"),
}
