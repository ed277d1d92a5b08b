"""AdamW over a tree of tensors. Port of ``repro/optim/adam.py``.

The optimizer only ever sees the adapter tree (2.3% of the model's
parameters, paper Table I), so its state is small. State is f32 whatever
the parameter dtype. The arithmetic is the reference's, operation for
operation (``torch.optim.AdamW`` orders it otherwise): clipping by the
global norm with a ``max(gnorm, 1e-9)`` floor, bias corrections
``1 - b**t`` in f32, weight decay added to the update, and the step
written as ``(p.f32 - lr * update).to(p.dtype)``. ``adamw_update``
returns new trees; ``adamw_update_`` writes the same values into the
given ones, which is what a CUDA graph of the calibration step replays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    mu: Pytree
    nu: Pytree


def adamw_init(params: Pytree) -> AdamState:
    leaves = tree_lib.tensors(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=tree_lib.map_tensors(zeros, params),
                     nu=tree_lib.map_tensors(zeros, params))


def global_norm(tree: Pytree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_lib.tensors(tree)]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adam_betas(cfg: AdamW, device) -> tuple:
    """``(b1, b2)`` as f32 scalars on ``device``: the bases of the bias
    corrections ``1 - b**t``."""
    return tuple(torch.tensor(b, dtype=torch.float32, device=device)
                 for b in (cfg.b1, cfg.b2))


def _adamw(grads: Pytree, step: torch.Tensor, mu: Pytree, nu: Pytree, params: Pytree,
           cfg: AdamW, b1: torch.Tensor, b2: torch.Tensor):
    """The update's arithmetic at the (already advanced) ``step``: returns
    new ``(params, mu, nu)`` trees; nothing is written."""
    if cfg.grad_clip is not None:
        denom = torch.clamp_min(global_norm(grads), 1e-9)
        # a tensor numerator: the division stays IEEE on the card too
        scale = torch.clamp_max(torch.full_like(denom, cfg.grad_clip) / denom, 1.0)
        grads = tree_lib.map_tensors(lambda g: g.to(torch.float32) * scale, grads)
    else:
        grads = tree_lib.map_tensors(lambda g: g.to(torch.float32), grads)
    mu = tree_lib.zip_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, mu, grads)
    nu = tree_lib.zip_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, nu, grads)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)

    def upd(p, m, v):
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - cfg.lr * update).to(p.dtype)

    return tree_lib.zip_map(upd, params, mu, nu), mu, nu


@torch.no_grad()
def adamw_update(grads: Pytree, state: AdamState, params: Pytree, cfg: AdamW):
    """Returns ``(new_params, new_state)``; the inputs are not written."""
    step = state.step + 1
    new_params, mu, nu = _adamw(grads, step, state.mu, state.nu, params, cfg,
                                *adam_betas(cfg, step.device))
    return new_params, AdamState(step=step, mu=mu, nu=nu)


@torch.no_grad()
def adamw_update_(grads: Pytree, state: AdamState, params: Pytree, cfg: AdamW,
                  betas: tuple) -> None:
    """``adamw_update`` written in place: ``state.step`` advances by one,
    and the new values are copied into ``params``, ``state.mu`` and
    ``state.nu``. ``betas`` is ``adam_betas(cfg, device)``, made once by
    the caller: the step then copies nothing from the host, so a CUDA
    graph can hold it, and reads its count from the device."""
    state.step.add_(1)
    new_params, mu, nu = _adamw(grads, state.step, state.mu, state.nu, params, cfg, *betas)
    for old, new in ((params, new_params), (state.mu, mu), (state.nu, nu)):
        for dst, src in zip(tree_lib.tensors(old), tree_lib.tensors(new)):
            dst.copy_(src)
