"""Full-state checkpoints: the reference's ``torch.save((capture(), iter))``
(train.py:160-162, gaussian_model.py:68-100), counterpart of
``pcp_tpu/train/checkpoint.py``.

A checkpoint is one ``torch.save`` of ``{"leaves": [...], "iteration": it}``:
every leaf of the ``TrainState`` in a fixed order (``leaves``) as a CPU
tensor, or an int for each Adam ``count``, which lives on the host. It holds
the params and ``alive``, the appearance embeddings and net, both Adam
states and the densify stats, so a resumed run restarts from the same bits.
``load`` reads it with ``torch.load(weights_only=True)`` into a template
state of the same structure (``train.loop.init_state``), in place, and
raises ``ValueError`` when the leaf count or a shape differs. The files are
``chkpnt<it>.pth``, the reference's name; the JAX package writes ``.npz``,
and neither package reads the other's.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from pcp_tpu_torch.train.step import TrainState


def _adam_slots(opt) -> List[Tuple[Any, Any]]:
    out = [(opt[m][k], i) for m in ("mu", "nu") for k in opt[m]
           for i in range(len(opt[m][k]))]
    return out + [(opt, "count")]


def _slots(state: TrainState) -> List[Tuple[Any, Any]]:
    """(container, key) of every leaf of ``state``, in the checkpoint's
    order: ``container[key]`` is a tensor, or the int of an Adam count."""
    out = [(state.params, k) for k in state.params]
    if state.app is not None:
        out.append((state.app, "embeddings"))
        net = list(state.app["net"].parameters())
        out += [(net, i) for i in range(len(net))]
    out += _adam_slots(state.opt_g)
    if state.opt_a is not None:
        out += _adam_slots(state.opt_a)
    out.append((vars(state), "alive"))
    out += [(state.stats, k) for k in state.stats]
    return out


def leaves(state: TrainState) -> list:
    """Every leaf of ``state`` in the checkpoint's order (tensors as they
    are, counts as ints)."""
    return [c[k] for c, k in _slots(state)]


def host_leaves(state: TrainState) -> List[np.ndarray]:
    """A host copy of every leaf, as numpy arrays."""
    return [v.detach().cpu().numpy().copy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for v in leaves(state)]


def save(path: str, state: TrainState, iteration: int) -> None:
    saved = [v.detach().cpu() if isinstance(v, torch.Tensor) else int(v)
             for v in leaves(state)]
    torch.save({"leaves": saved, "iteration": int(iteration)}, path)


def load(path: str, template: TrainState) -> Tuple[TrainState, int]:
    """``template`` is a TrainState with the right structure and shapes (a
    freshly initialised one); its leaves are overwritten in place with the
    checkpoint's. Returns (state, iteration)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    saved = data["leaves"]
    slots = _slots(template)
    if len(saved) != len(slots):
        raise ValueError(
            f"checkpoint {path!r} has {len(saved)} leaves but the template "
            f"has {len(slots)} — was it saved with a different capacity or "
            "use_appearance setting?"
        )
    for i, ((container, key), value) in enumerate(zip(slots, saved)):
        cur = container[key]
        if not isinstance(cur, torch.Tensor):
            container[key] = int(value)
            continue
        if tuple(value.shape) != tuple(cur.shape):
            raise ValueError(
                f"checkpoint {path!r} leaf {i} has shape "
                f"{tuple(value.shape)} but the template expects "
                f"{tuple(cur.shape)} — capacity or model config mismatch"
            )
        with torch.no_grad():
            cur.copy_(value)
    return template, int(data["iteration"])
