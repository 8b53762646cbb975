"""Functional Adam with per-group learning rates and moment surgery
(counterpart of ``pcp_tpu/train/optim.py``; the reference's six Adam groups
and its optimizer-state surgery, gaussian_model.py:159-187, :280-355).

A group is a tensor or a list of tensors (the appearance net's convs).
State = {"mu": {group: [tensors]}, "nu": ..., "count": int}; the count lives
on the host, so reading it never waits for the card. Updates are in place:
the parameters and moments are the step's largest buffers and are not
copied. B1, B2 = 0.9, 0.999 and EPS = 1e-15 as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

LrSpec = Union[float, Callable[[int], float]]

B1, B2 = 0.9, 0.999
EPS = 1e-15


def _leaves(group) -> List[torch.Tensor]:
    return list(group) if isinstance(group, (list, tuple)) else [group]


def init_adam(params: Mapping) -> Dict:
    return {
        "mu": {k: [torch.zeros_like(t) for t in _leaves(g)]
               for k, g in params.items()},
        "nu": {k: [torch.zeros_like(t) for t in _leaves(g)]
               for k, g in params.items()},
        "count": 0,
    }


def _f32_pow(base: float, t: int) -> float:
    """base**t in fp32, as the JAX package evaluates the bias corrections."""
    return float(torch.tensor(base, dtype=torch.float32) ** float(t))


def adam_step(params: Mapping, grads: Mapping, state: Dict,
              lrs: Mapping[str, LrSpec], step: Optional[int] = None) -> Dict:
    """One Adam update of every group of ``params`` in place. ``lrs`` holds
    a float or a schedule(step) -> lr per group; ``step`` defaults to the
    updated count. Returns ``state`` (updated in place)."""
    state["count"] += 1
    t = state["count"]
    bc1 = 1.0 - _f32_pow(B1, t)
    bc2 = 1.0 - _f32_pow(B2, t)
    step = t if step is None else step
    with torch.no_grad():
        for k, group in params.items():
            spec = lrs[k]
            lr = spec(step) if callable(spec) else spec
            for p, g, m, v in zip(_leaves(group), _leaves(grads[k]),
                                  state["mu"][k], state["nu"][k]):
                m.copy_(B1 * m + (1 - B1) * g)
                v.copy_(B2 * v + (1 - B2) * g * g)
                p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
    return state


def zero_moments(state: Dict, written_mask: torch.Tensor,
                 keys: Optional[Sequence[str]] = None) -> Dict:
    """Zero the moments at the slots flagged in ``written_mask`` (C,) of
    every leaf whose leading dim is C -- the densification surgery.
    ``keys`` limits the groups touched (None = all). In place."""
    c = written_mask.shape[0]
    for k in state["mu"] if keys is None else keys:
        for leaf in state["mu"][k] + state["nu"][k]:
            if leaf.dim() >= 1 and leaf.shape[0] == c:
                leaf.masked_fill_(
                    written_mask.reshape((c,) + (1,) * (leaf.dim() - 1)), 0.0)
    return state
