"""Dual-optimizer scheme with gated, name-filtered Adam groups (port of
``train/optim.py``).

Three Adam groups over name-filtered parameter lists (reference
main.py:98-123): ``gnn`` (names containing 'gcn' for the GCN backbone),
``edge`` (names containing 'edge_prob_mlp') and ``all`` (every parameter,
with weight decay, for the baseline modes). Learned-mode steps update the
gnn group always and the edge group when the conditional gate passes.

Two quirks are kept on purpose, as in the JAX package:
  * the groups overlap: 'edge_prob_mlp.gcn1.*' matches both filters, so
    those parameters receive the sum of both updates when the gate passes;
  * a skipped group's moments and step count do not advance.

The gate is a device tensor and enters as a 0/1 factor (both updates are
computed, then selected), so a step never waits for the card to decide;
an ungated group adds its update as it is, with no host value copied to
the card.
Both groups' updates are computed from the same parameters and gradients
and then added, ``p + upd_edge + upd_gnn``, in that order.

Every step and ``load_state_dict`` write the state in place (the step
count, the moments) and never rebind it, so a captured CUDA graph that
replays the update keeps reading and writing the optimizer's tensors
(``train/pipelines.py`` ``make_scan_epoch_step``). A group's moments are
allocated at its first step, outside any capture: graphs are captured
after an eager step of the same case.

With ``core/spans``' device stamps on, each ``step_*`` ends with the stamp
``optimizer``: the device time of the whole update.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..core import spans


def gnn_filter_for(gnn: str) -> Callable[[str], bool]:
    """Name filter replicating reference main.py:100/103/106/109; GCNII's
    parameters (``models/backbones.py`` ``GCNIIModel``) carry "GCNII",
    which no scorer name holds."""
    token = {"GCN": "gcn", "Cheb": "gcn", "GIN": "GIN", "GAT": "GAT",
             "GCNII": "GCNII"}[gnn]
    return lambda name: token in name


def edge_filter(name: str) -> bool:
    return "edge_prob_mlp" in name


@dataclasses.dataclass
class AdamGroupState:
    count: torch.Tensor                     # scalar int32 on the device
    mu: List[Optional[torch.Tensor]]        # None outside the group
    nu: List[Optional[torch.Tensor]]


class DualOptimizer:
    """Holds the module's parameters, the group masks and the three Adam
    states; the steps update the parameters in place."""

    def __init__(self, named_params, gnn: str, lr: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.names, params = zip(*named_params)
        self.params = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        gnn_pred = gnn_filter_for(gnn)
        self.masks: Dict[str, List[bool]] = {
            "gnn": [gnn_pred(n) for n in self.names],
            "edge": [edge_filter(n) for n in self.names],
            "all": [True] * len(self.names),
        }
        # a group's moments are allocated at its first step: the learned
        # mode never steps 'all'
        self.state: Dict[str, AdamGroupState] = {}

    @staticmethod
    def create(model: torch.nn.Module, gnn: str, lr: float,
               weight_decay: float) -> "DualOptimizer":
        return DualOptimizer(model.named_parameters(), gnn, lr, weight_decay)

    def _group_state(self, grp: str) -> AdamGroupState:
        if grp not in self.state:
            mask = self.masks[grp]
            self.state[grp] = AdamGroupState(
                torch.zeros((), dtype=torch.int32,
                            device=self.params[0].device),
                [torch.zeros_like(p) if m else None
                 for p, m in zip(self.params, mask)],
                [torch.zeros_like(p) if m else None
                 for p, m in zip(self.params, mask)])
        return self.state[grp]

    def state_dict(self) -> Dict[str, dict]:
        """The groups' Adam states (step count, moments; None outside the
        group), for a checkpoint. Only groups that have stepped appear."""
        return {grp: {"count": st.count, "mu": list(st.mu),
                      "nu": list(st.nu)} for grp, st in self.state.items()}

    def load_state_dict(self, state: Dict[str, dict]) -> None:
        """Restore ``state_dict()``'s output onto the parameters' device,
        copied into the groups' existing tensors (graphs captured before the
        load keep reading them); a group the state lacks restarts at step 0
        with zero moments, as a group that never stepped."""
        for grp in set(self.state) | set(state):
            st = self._group_state(grp)
            src = state.get(grp)
            if src is None:
                st.count.zero_()
                for t in st.mu + st.nu:
                    if t is not None:
                        t.zero_()
                continue
            st.count.copy_(src["count"])
            for dst, s in zip(st.mu + st.nu, list(src["mu"]) + list(src["nu"])):
                if (dst is None) != (s is None):
                    raise ValueError(f"optimizer state of group {grp!r} "
                                     "does not match the group's parameters")
                if dst is not None:
                    dst.copy_(s)

    def _group_update(self, grp: str, grads, gate=None,
                      weight_decay: float = 0.0):
        """One Adam step of group ``grp``; returns the updates (None outside
        the group). With a ``gate`` (a bool tensor on the parameters'
        device) the state advances where it holds and the updates are zero
        where it does not; without one the group always steps. The count
        and the moments are updated in place."""
        st = self._group_state(grp)
        do_f = None if gate is None else gate.to(torch.float32)
        st.count.add_(1 if gate is None else gate.to(torch.int32))
        t = torch.clamp(st.count, min=1).to(torch.float32)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        updates = []
        for i, (g, p) in enumerate(zip(grads, self.params)):
            m, v = st.mu[i], st.nu[i]
            if m is None:
                updates.append(None)
                continue
            if weight_decay:
                g = g + weight_decay * p
            if do_f is None:
                m_new = m.mul_(b1).add_((1.0 - b1) * g)
                v_new = v.mul_(b2).add_((1.0 - b2) * (g * g))
            else:
                m_new = b1 * m + (1.0 - b1) * g
                v_new = b2 * v + (1.0 - b2) * (g * g)
            upd = -self.lr * (m_new / bc1) / (torch.sqrt(v_new / bc2)
                                              + self.eps)
            if do_f is not None:
                # lerp with a weight of exactly 0 or 1 returns one end bit
                # for bit: the moments advance where the gate holds
                m.lerp_(m_new, do_f)
                v.lerp_(v_new, do_f)
                upd = do_f * upd
            updates.append(upd)
        return updates

    def _apply(self, *update_lists):
        for i, p in enumerate(self.params):
            for ups in update_lists:
                if ups[i] is not None:
                    p.add_(ups[i])

    @torch.no_grad()
    def step_learned(self, grads, update_edge) -> None:
        """Learned mode: the gnn group always steps, the edge group only
        where ``update_edge`` (the conditional gate, a bool tensor on the
        parameters' device) holds."""
        upd_e = self._group_update("edge", grads, update_edge)
        upd_g = self._group_update("gnn", grads)
        self._apply(upd_e, upd_g)
        spans.stamp("optimizer", self.params[0].device)

    @torch.no_grad()
    def step_gnn_only(self, grads) -> None:
        """Small-batch path (E <= q): only the gnn group steps."""
        self._apply(self._group_update("gnn", grads))
        spans.stamp("optimizer", self.params[0].device)

    @torch.no_grad()
    def step_all(self, grads) -> None:
        """Baseline modes: the third group, with weight decay."""
        self._apply(self._group_update("all", grads,
                                       weight_decay=self.weight_decay))
        spans.stamp("optimizer", self.params[0].device)
