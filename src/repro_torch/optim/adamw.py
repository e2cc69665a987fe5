"""AdamW with optional reduced-precision state and global-norm clipping.

The port's copy of the JAX package's ``optim/adamw.py``.  The state holds
``m`` and ``v`` as dicts keyed by the parameter module's names
(``layers.3.attn.wq``), with ``step`` a 0-d int32 tensor on the device;
``update`` writes the parameters, ``m`` and ``v`` in place (JAX returns
new trees; with donation it reuses the buffers alike).

As in JAX, the schedule and the bias corrections are computed in float32
from the step, and the update math runs in float32 whatever the state's
dtype (``state_dtype="bfloat16"`` halves optimizer memory).  Weight decay
goes to every leaf of rank >= 2 *of the JAX tree*, whose layer lists are
stacked on leading axes: a per-layer norm scale, (d,) here, is (L, d)
there and is decayed; only unstacked vectors such as ``ln_f.scale`` are
not (``models/convert.py::stacked_rank``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from ..models.convert import stacked_rank

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    m: Tensors
    v: Tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr; ``step`` a
    float32 tensor, the result float32."""
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: AdamWConfig, params: nn.Module) -> AdamWState:
    sdt = getattr(torch, cfg.state_dtype)
    named = list(params.named_parameters())
    dev = named[0][1].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros(p.shape, dtype=sdt, device=dev) for n, p in named},
        v={n: torch.zeros(p.shape, dtype=sdt, device=dev) for n, p in named},
    )


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of every tensor's float32 sum of squares."""
    total = sum(torch.sum(torch.square(g.float())) for g in tree.values())
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tensors, state: AdamWState,
           params: nn.Module) -> Tuple[nn.Module, AdamWState, dict]:
    """One AdamW step from ``grads`` (keyed like ``state.m``): writes the
    parameters, ``m`` and ``v`` in place and returns (params, the state
    with the next step, {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    stepf = step.float()
    lr = schedule(cfg, stepf)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for name, p in params.named_parameters():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if stacked_rank(name, p) >= 2 and cfg.weight_decay:  # no decay on norms
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                        "lr": lr}
