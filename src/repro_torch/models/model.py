"""Unified model facade: one object per architecture family.

The port's copy of the JAX package's ``models/model.py``.
``build_model(cfg, device="cuda")`` returns a :class:`Model` exposing:
  * ``init(generator) -> params``  (a ``torch.Generator`` on the device)
  * ``loss(params, batch) -> scalar``  (training objective, float32)
  * ``prefill(params, batch) -> last-token logits``  (inference prefill)
  * ``init_cache(batch, max_seq) -> cache``
  * ``decode(params, cache, tokens, pos) -> (logits, cache)``
  * ``hidden(params, batch) -> final hidden states`` (B, S, d)
  * ``blocks(params, tokens)`` / ``decode_blocks(params, cache, pos)``:
    the stack as a list of functions of the residual stream, for
    checking a model block by block (``moe``, ``ssm_hybrid`` and
    ``xlstm``; None for the others)

The MoE family's ``prefill``, ``hidden``, ``blocks``, ``decode`` and
``decode_blocks`` also take ``routes=`` (a list each MoE layer call appends its
``moe.Route`` to); the others refuse it.

Batches are dicts of tensors on the model's device (``tokens``;
``patch_embeds`` for the patch frontend; ``frames`` (B, T_enc,
frontend_dim) for the encoder-decoder family; ``labels`` for ``loss``).
``prefill`` and ``decode`` run under ``torch.no_grad()``: serving builds
no autograd graph.  Every family is ported:
``dense`` and ``vlm`` (``transformer``), ``moe``, ``ssm_hybrid``
(``ssm``), ``xlstm`` and ``encdec``.  As in the JAX package, ``decode``
of an encoder-decoder model attends to the cache's cross-attention KV,
which only ``encdec.prefill_cross`` fills (zeros otherwise).
``batch_spec(shape)`` gives the inputs of a shape as meta tensors, for the
dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..device import Device, resolve_device
from . import encdec, moe, ssm, transformer, xlstm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    loss: Callable
    prefill: Callable
    init_cache: Callable
    decode: Callable
    hidden: Callable
    blocks: Optional[Callable] = None
    decode_blocks: Optional[Callable] = None

    def batch_spec(self, shape: ShapeConfig,
                   per_host_batch: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins for the inputs of this (arch, shape), with
        the JAX package's shapes and dtypes: ``tokens`` and ``labels``
        int32 (b, s) for train (prefill drops ``labels``), plus ``frames``
        (b, encoder_seq, frontend_dim) for the encoder-decoder family and
        ``patch_embeds`` (b, num_patches, frontend_dim) for the patch
        frontend, in the activation dtype; decode takes ``tokens`` (b, 1)
        and a 0-d int32 ``pos``.

        The port's ``decode`` takes ``pos`` as a Python int, so the dry run
        decodes at ``shape.seq_len - 1``, the deepest position; JAX's
        compiled decode attends over the whole masked cache at any
        position, so the work is the same."""
        b = per_host_batch or shape.global_batch
        s = shape.seq_len
        cfg = self.cfg

        def spec(shape_, dtype=torch.int32):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            out = {"tokens": spec((b, s)), "labels": spec((b, s))}
            if cfg.family == "encdec":
                out["frames"] = spec((b, cfg.encoder_seq, cfg.frontend_dim),
                                     cfg.activation_dtype)
            if cfg.frontend == "patch":
                out["patch_embeds"] = spec(
                    (b, cfg.num_patches, cfg.frontend_dim),
                    cfg.activation_dtype)
            if shape.kind == "prefill":
                out.pop("labels")
            return out
        # decode: one new token against a seq_len-deep cache
        return {"tokens": spec((b, 1)), "pos": spec(())}


_MODULES = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "ssm_hybrid": ssm,
    "xlstm": xlstm,
    "encdec": encdec,
}


def build_model(cfg: ArchConfig, device: Device = "cuda") -> Model:
    device = resolve_device(device)
    module = _MODULES[cfg.family]

    @torch.no_grad()
    def prefill(params, batch, **kw):
        hidden = module.hidden(params, cfg, batch, **kw)
        return transformer.logits_fn(params, cfg, hidden[:, -1])

    def bind(name: str) -> Optional[Callable]:
        """``module.name(params, cfg, ...)`` as ``(params, ...)``."""
        fn = getattr(module, name, None)
        if fn is None:
            return None
        return lambda params, *args, **kw: fn(params, cfg, *args, **kw)

    return Model(
        cfg=cfg,
        device=device,
        init=lambda gen: module.init_params(gen, cfg, device),
        loss=bind("loss_fn"),
        prefill=prefill,
        init_cache=lambda b, s, dtype=None: module.init_cache(
            cfg, b, s, dtype, device=device),
        decode=torch.no_grad()(bind("decode_step")),
        hidden=bind("hidden"),
        blocks=bind("blocks"),
        decode_blocks=bind("decode_blocks"),
    )
