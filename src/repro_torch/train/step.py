"""The train step (loss -> grad -> AdamW) and the serve steps, on one
device or over a mesh.

The port's copy of the JAX package's ``train/step.py``.
``build_train_step(model, mesh, opt_cfg=..., fsdp=..., microbatch=...)``
returns ``(train_step, (p_specs, o_specs), opt_cfg)`` (the specs None
without a mesh); ``train_step(params, opt_state, batch) -> (params,
opt_state, metrics)`` updates the parameter module and the AdamW state in
place and returns them with ``{"loss", "grad_norm", "lr"}`` (0-d float32
tensors on the device, not synchronised).  ``microbatch > 1`` splits the
batch into that many contiguous row blocks (JAX's reshape, each block
constrained to ``(None, DP, ...)``), sums their gradients in float32,
divides by ``microbatch`` and reports the mean loss.

Over a mesh the step enters ``ctx.activation_mesh`` around the whole of
the forward, the backward and the AdamW update.  The backward recomputes
each block under ``tuning.remat_wrap``, and that recomputation reads the
mesh (and the ``capacity_factor`` knob) again: the MoE must take the same
route, at the same capacity, in both passes, as JAX's one trace does.
The specs are descriptions (``parallel/ctx.py``): ``fsdp`` changes the
returned specs, not the values.

Parameters are made with ``requires_grad=False`` (serving builds no
graph); ``value_and_grad`` turns it on for its backward pass and off
again.

``build_serve_prefill`` / ``build_serve_decode`` return the serve steps
over a mesh with their parameter (and cache) specs: each step enters
``ctx.activation_mesh`` for the call, so the MoE dispatch and (with the
``flash_decode`` knob) the decode attention run shard by shard, and every
constraint is resolved against the mesh.  ``auto_microbatch`` picks the
dry run's gradient-accumulation factor from the ``micro_tokens`` knob.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import tuning
from ..models.convert import PARAMS
from ..models.model import _MODULES, Model
from ..optim import adamw
from ..parallel import ctx
from ..parallel.ctx import PartitionSpec, dp_axes
from ..parallel.sharding import cache_pspecs, param_pspecs

Batch = Dict[str, torch.Tensor]


def needs_fsdp(model: Model) -> bool:
    """FSDP once params+optimizer at TP-only sharding would crowd HBM:
    ~12 bytes/param over 16 TP shards > ~2 GiB/chip  =>  ~3B params."""
    return model.cfg.param_count() > 3e9


def auto_microbatch(global_batch: int, seq: int, mesh,
                    target_tokens_per_device: Optional[int] = None) -> int:
    """Gradient-accumulation factor: keep per-device live activation tokens
    near ``target_tokens_per_device`` (default: the ``micro_tokens``
    knob), constrained to divide the per-device batch.  ``mesh`` is read
    for its data-parallel axes only."""
    if target_tokens_per_device is None:
        target_tokens_per_device = tuning.get("micro_tokens")
    dp = 1
    for a in dp_axes(mesh):
        dp *= mesh.shape[a]
    b_local = max(1, global_batch // dp)
    micro = max(1, (b_local * seq) // target_tokens_per_device)
    micro = min(micro, b_local)
    while b_local % micro:
        micro -= 1
    return micro


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


def train_pspecs(model: Model, mesh, opt_cfg: adamw.AdamWConfig,
                 fsdp: bool) -> Tuple[Dict[str, PartitionSpec],
                                      adamw.AdamWState]:
    """(p_specs, o_specs) of ``model``'s train state on ``mesh``: each
    parameter's spec, and an ``AdamWState`` of ``step``'s (replicated) and
    ``m``'s and ``v``'s, all keyed by the parameter names."""
    p_abs = abstract_params(model)
    o_abs = adamw.init(opt_cfg, p_abs)
    return param_pspecs(p_abs, mesh, fsdp=fsdp), adamw.AdamWState(
        step=PartitionSpec(),
        m=param_pspecs(o_abs.m, mesh, fsdp=fsdp),
        v=param_pspecs(o_abs.v, mesh, fsdp=fsdp))


def build_train_step(model: Model, mesh=None,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     fsdp: Optional[bool] = None,
                     microbatch: int = 1):
    """Returns (train_step, (p_specs, o_specs), opt_cfg).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    ``fsdp=None`` means ``needs_fsdp(model)``; the specs are None when
    ``mesh`` is."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        state_dtype="bfloat16" if model.cfg.param_count() > 2e11 else "float32")
    fsdp = needs_fsdp(model) if fsdp is None else fsdp
    specs = (None, None) if mesh is None else train_pspecs(
        model, mesh, opt_cfg, fsdp)

    def train_step(params, opt_state, batch):
        ctx_mesh = (contextlib.nullcontext() if mesh is None
                    else ctx.activation_mesh(mesh))
        with ctx_mesh:
            return _train_step_inner(params, opt_state, batch)

    def split(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % microbatch:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{microbatch} microbatches")
        x = x.reshape(microbatch, x.shape[0] // microbatch, *x.shape[1:])
        return ctx.constrain(x, (None, ctx.DP) + (None,) * (x.ndim - 2))

    def _train_step_inner(params, opt_state, batch):
        if microbatch > 1:
            sliced = {k: split(x) for k, x in batch.items()}
            gsum, losses = None, []
            for i in range(microbatch):
                loss, g = value_and_grad(
                    model, params, {k: x[i] for k, x in sliced.items()})
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

    return train_step, specs, opt_cfg


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
