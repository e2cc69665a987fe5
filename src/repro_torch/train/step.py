"""The train step (loss -> grad -> AdamW, on one device) and the serve
steps over a mesh.

The port's copy of the JAX package's ``train/step.py``.
``build_train_step(model, opt_cfg=...)`` returns ``(train_step,
opt_cfg)``; ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)`` updates the parameter module and the AdamW state in place and
returns them with ``{"loss", "grad_norm", "lr"}`` (0-d float32 tensors
on the device, not synchronised).  ``microbatch > 1`` splits the batch
into that many contiguous row blocks (JAX's reshape), sums their
gradients in float32, divides by ``microbatch`` and reports the mean
loss.

Parameters are made with ``requires_grad=False`` (serving builds no
graph); ``value_and_grad`` turns it on for its backward pass and off
again.

``build_serve_prefill`` / ``build_serve_decode`` return the serve steps
over a mesh with their parameter (and cache) specs: each step enters
``ctx.activation_mesh`` for the call, so the MoE dispatch and (with the
``flash_decode`` knob) the decode attention run shard by shard, and every
constraint is resolved against the mesh.  Training over a mesh and FSDP
are ROADMAP item 11d (iii); ``auto_microbatch``, whose only caller is the
dry run, is item 11e.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.convert import PARAMS
from ..models.model import _MODULES, Model
from ..optim import adamw
from ..parallel import ctx
from ..parallel.sharding import cache_pspecs, param_pspecs

Batch = Dict[str, torch.Tensor]


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what} over a mesh is not ported yet: ROADMAP item 11d (iii)")


def needs_fsdp(model: Model) -> bool:
    """FSDP once params+optimizer at TP-only sharding would crowd HBM:
    ~12 bytes/param over 16 TP shards > ~2 GiB/chip  =>  ~3B params."""
    return model.cfg.param_count() > 3e9


def abstract_params(model: Model) -> nn.Module:
    """The model's parameter module on the meta device: shapes and dtypes,
    no storage (``checkpoint.restore`` materialises it)."""
    return PARAMS[model.cfg.family](model.cfg, torch.device("meta"))


def value_and_grad(model: Model, params: nn.Module, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``model.loss(params, batch)`` and its gradient with respect to every
    parameter, keyed by the module's names (zeros where a parameter does
    not reach the loss, as JAX's grad gives)."""
    named = list(params.named_parameters())
    for _, p in named:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True)
    finally:
        for _, p in named:
            p.requires_grad_(False)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(named, grads)}


def build_train_step(model: Model, mesh=None,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     fsdp: Optional[bool] = None,
                     microbatch: int = 1) -> Tuple[Callable, adamw.AdamWConfig]:
    """Returns (train_step, opt_cfg).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    ``fsdp=None`` means none on one device (JAX decides by its
    ``needs_fsdp``); ``fsdp=True`` or a mesh raises (ROADMAP 11d (iii))."""
    _no_mesh(mesh, "build_train_step")
    if fsdp:
        raise NotImplementedError(
            "FSDP is not ported yet: ROADMAP item 11d (iii)")
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        state_dtype="bfloat16" if model.cfg.param_count() > 2e11 else "float32")

    def train_step(params, opt_state, batch):
        if microbatch > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatch:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatch} microbatches")
            rows = b // microbatch
            gsum, losses = None, []
            for i in range(microbatch):
                mb = {k: x[i * rows:(i + 1) * rows] for k, x in batch.items()}
                loss, g = value_and_grad(model, params, mb)
                losses.append(loss)
                if gsum is None:
                    gsum = {n: x.float() for n, x in g.items()}
                else:
                    for n, x in g.items():
                        gsum[n] += x
                del g
            grads = {n: x / microbatch for n, x in gsum.items()}
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(model, params, batch)
        params, opt_state, metrics = adamw.update(opt_cfg, grads, opt_state,
                                                  params)
        return params, opt_state, {**metrics, "loss": loss}

    return train_step, opt_cfg


def build_serve_prefill(model: Model, mesh):
    """prefill(params, batch) -> last-token logits; returns (fn, p_specs).
    Keywords go on to ``model.prefill`` (``routes=`` of the MoE family)."""
    p_specs = param_pspecs(abstract_params(model), mesh,
                           fsdp=needs_fsdp(model))

    def prefill(params, batch, **kw):
        with ctx.activation_mesh(mesh):
            return model.prefill(params, batch, **kw)

    return prefill, p_specs


def build_serve_decode(model: Model, mesh, batch: int, max_seq: int):
    """decode(params, cache, tokens, pos) -> (logits, cache); returns
    (fn, p_specs, c_specs, cache_shapes), ``cache_shapes`` the cache's
    tensors on the meta device.  Keywords go on to ``model.decode``."""
    p_specs = param_pspecs(abstract_params(model), mesh,
                           fsdp=needs_fsdp(model))
    cache_abs = _MODULES[model.cfg.family].init_cache(
        model.cfg, batch, max_seq, device="meta")
    c_specs = cache_pspecs(cache_abs, mesh)

    def decode(params, cache, tokens, pos, **kw):
        with ctx.activation_mesh(mesh):
            return model.decode(params, cache, tokens, pos, **kw)

    return decode, p_specs, c_specs, cache_abs
