"""Performance knobs read by model code while it runs.

The port's copy of the JAX package's knob registry, with every one of its
knobs and their defaults (the paper-faithful baseline): ``q_chunk``
(attention query-block size), ``scores_dtype``, ``gqa_native`` and
``act_bf16`` (serving), ``xent_chunk``, ``remat`` and ``grad_bf16``
(training), ``capacity_factor``, ``flash_decode`` and ``seq_shard_mlp``
(the mesh paths: ``seq_shard_mlp`` makes the dense and MoE prefill and
training forward sequence parallel, ``models/transformer.py``), and
``micro_tokens`` (``train/step.py::auto_microbatch``, which the dry run
reads), plus ``get``, ``overrides``, ``parse`` and ``remat_wrap``.  An
unknown name raises ``KeyError``.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict

import torch
from torch.utils import checkpoint as _checkpoint

_DEFAULTS: Dict[str, Any] = {
    "q_chunk": 512,          # attention query-block size
    "xent_chunk": 256,       # sequence chunk of the softmax-xent loop
    "scores_dtype": "f32",   # attention score accumulation dtype
    "micro_tokens": 8192,    # per-device tokens per microbatch target
    "remat": "full",         # full | dots | none
    "gqa_native": False,     # score einsum against Kv heads (no K/V repeat)
    "act_bf16": False,       # norms/gelu: f32 statistics, bf16 application
    "grad_bf16": False,      # cast the loss cotangent to bf16 at the xent boundary
    "flash_decode": False,   # per-shard partial-softmax decode attention
    "capacity_factor": 0.0,  # >0 overrides the sharded MoE capacity factor
    "seq_shard_mlp": False,  # sequence-parallel residual stream over `model`
}


def _known(name: str) -> str:
    if name not in _DEFAULTS:
        raise KeyError(f"unknown tuning knob {name!r}")
    return name


_STATE = dict(_DEFAULTS)


def get(name: str):
    return _STATE[_known(name)]


def scores_dtype() -> torch.dtype:
    return torch.bfloat16 if _STATE["scores_dtype"] == "bf16" else torch.float32


# the products ``remat="dots"`` keeps for the backward pass, as JAX's
# ``dots_with_no_batch_dims_saveable`` keeps every dot with no batch
# dimension: ``mm``, ``addmm`` and ``matmul``, and ``bmm`` over a batch of
# one (``torch.einsum``'s form of a contraction with no batch dimension,
# such as the projections ``bsd,dhk->bshk``).  Everything else, the
# attention's batched score and value products included, is recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.matmul.default)


def _dots_policy(ctx, op, *args, **kwargs):
    CP = _checkpoint.CheckpointPolicy
    if op in _SAVED_DOTS or (op is torch.ops.aten.bmm.default
                             and args[0].shape[0] == 1):
        return CP.MUST_SAVE
    return CP.PREFER_RECOMPUTE


def remat_wrap(fn: Callable) -> Callable:
    """``fn`` under the ``remat`` knob's activation checkpointing:
    ``"full"`` keeps only ``fn``'s inputs and recomputes the rest in the
    backward pass, ``"dots"`` also keeps the products listed at
    ``_SAVED_DOTS``, ``"none"`` returns ``fn`` itself.  Read when the
    wrapper is made, as JAX reads it when tracing."""
    mode = _STATE["remat"]
    if mode == "none":
        return fn
    kw: Dict[str, Any] = {"use_reentrant": False}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            _checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    elif mode != "full":
        raise ValueError(f"remat must be full, dots or none, not {mode!r}")

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():     # nothing to keep for a backward
            return fn(*args)
        return _checkpoint.checkpoint(fn, *args, **kw)
    return wrapped


@contextlib.contextmanager
def overrides(**kwargs):
    for k in kwargs:
        _known(k)
    old = dict(_STATE)
    _STATE.update(kwargs)
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)


def parse(spec: str) -> Dict[str, Any]:
    """'q_chunk=1024;scores_dtype=bf16' -> typed kwargs."""
    out: Dict[str, Any] = {}
    if not spec or spec == "baseline":
        return out
    for part in spec.split(";"):
        k, _, v = part.partition("=")
        k = _known(k.strip())
        proto = _DEFAULTS[k]
        if isinstance(proto, bool):
            out[k] = v.strip().lower() in ("1", "true", "on")
        elif isinstance(proto, int):
            out[k] = int(v)
        elif isinstance(proto, float):
            out[k] = float(v)
        else:
            out[k] = v.strip()
    return out
