"""Unified model facade: one object per architecture family.

The port's copy of the JAX package's ``models/model.py``, serving part.
``build_model(cfg, device="cuda")`` returns a :class:`Model` exposing:
  * ``init(generator) -> params``  (a ``torch.Generator`` on the device)
  * ``prefill(params, batch) -> last-token logits``  (inference prefill)
  * ``init_cache(batch, max_seq) -> cache``
  * ``decode(params, cache, tokens, pos) -> (logits, cache)``

Batches are dicts of tensors on the model's device (``tokens``, and
``patch_embeds`` for the patch frontend).  The dense family (``dense``,
``vlm``) is ported; the others raise ``NotImplementedError``.  ``loss``
and ``batch_spec`` come with training and the dry-run tools.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from . import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    prefill: Callable
    init_cache: Callable
    decode: Callable


def _dense_model(cfg: ArchConfig, device: torch.device) -> Model:
    def prefill(params, batch):
        hidden = transformer.forward(params, cfg, batch["tokens"],
                                     batch.get("patch_embeds"))
        return transformer.logits_fn(params, cfg, hidden[:, -1])

    return Model(
        cfg=cfg,
        device=device,
        init=lambda gen: transformer.init_params(gen, cfg, device),
        prefill=prefill,
        init_cache=lambda b, s, dtype=None: transformer.init_cache(
            cfg, b, s, dtype, device=device),
        decode=lambda params, cache, tokens, pos: transformer.decode_step(
            params, cfg, cache, tokens, pos),
    )


_FAMILIES = {"dense": _dense_model, "vlm": _dense_model}
_UNPORTED = ("moe", "ssm_hybrid", "xlstm", "encdec")


def build_model(cfg: ArchConfig, device: Device = "cuda") -> Model:
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"moe, ssm_hybrid, xlstm and encdec families are ROADMAP item "
            f"11b")
    return _FAMILIES[cfg.family](cfg, resolve_device(device))
