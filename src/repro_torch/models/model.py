"""Unified model facade: one object per architecture family.

The port's copy of the JAX package's ``models/model.py``, serving part.
``build_model(cfg, device="cuda")`` returns a :class:`Model` exposing:
  * ``init(generator) -> params``  (a ``torch.Generator`` on the device)
  * ``prefill(params, batch) -> last-token logits``  (inference prefill)
  * ``init_cache(batch, max_seq) -> cache``
  * ``decode(params, cache, tokens, pos) -> (logits, cache)``
  * ``hidden(params, batch) -> final hidden states`` (B, S, d)
  * ``blocks(params, tokens)`` / ``decode_blocks(params, cache, pos)``:
    the stack as a list of functions of the residual stream, for
    checking a model block by block (``moe``, ``ssm_hybrid`` and
    ``xlstm``; None for the others)

The MoE family's ``hidden``, ``blocks``, ``decode`` and ``decode_blocks``
also take ``routes=`` (a list each MoE layer call appends its
``moe.Route`` to); the others refuse it.

Batches are dicts of tensors on the model's device (``tokens``;
``patch_embeds`` for the patch frontend; ``frames`` (B, T_enc,
frontend_dim) for the encoder-decoder family).  Every family is ported:
``dense`` and ``vlm`` (``transformer``), ``moe``, ``ssm_hybrid``
(``ssm``), ``xlstm`` and ``encdec``.  As in the JAX package, ``decode``
of an encoder-decoder model attends to the cache's cross-attention KV,
which only ``encdec.prefill_cross`` fills (zeros otherwise).  ``loss``
and ``batch_spec`` come with training and the dry-run tools.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from . import encdec, moe, ssm, transformer, xlstm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    prefill: Callable
    init_cache: Callable
    decode: Callable
    hidden: Callable
    blocks: Optional[Callable] = None
    decode_blocks: Optional[Callable] = None


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

    def prefill(params, batch):
        hidden = module.hidden(params, cfg, batch)
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
        prefill=prefill,
        init_cache=lambda b, s, dtype=None: module.init_cache(
            cfg, b, s, dtype, device=device),
        decode=bind("decode_step"),
        hidden=bind("hidden"),
        blocks=bind("blocks"),
        decode_blocks=bind("decode_blocks"),
    )
