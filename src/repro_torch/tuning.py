"""Performance knobs read by model code while it runs.

The port's copy of the JAX package's knob registry, holding the knobs that
the port reads: ``q_chunk`` (attention query-block size),
``scores_dtype``, ``gqa_native`` and ``act_bf16``, with the JAX package's
defaults (the paper-faithful baseline), plus ``get``, ``overrides`` and
``parse``.  The JAX package's other knobs are read by code the port does
not have yet; naming one raises ``NotImplementedError`` with the ROADMAP
item that brings it, so a setting never silently does nothing.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

_DEFAULTS: Dict[str, Any] = {
    "q_chunk": 512,          # attention query-block size
    "scores_dtype": "f32",   # attention score accumulation dtype
    "gqa_native": False,     # score einsum against Kv heads (no K/V repeat)
    "act_bf16": False,       # norms/gelu: f32 statistics, bf16 application
}

# The JAX package's knobs that the port does not read yet, each with the
# ROADMAP item that ports its reader.
_UNPORTED: Dict[str, str] = {
    "xent_chunk": "11c",       # chunked_xent (training)
    "micro_tokens": "11c",     # train/step.py's microbatching
    "remat": "11c",            # remat_wrap (training)
    "grad_bf16": "11c",        # the loss cotangent's cast (training)
    "capacity_factor": "11b",  # the moe family
    "seq_shard_mlp": "11d",    # parallel/: sequence-parallel MLP
    "flash_decode": "11d",     # parallel/: flash decode over shards
}


def _known(name: str) -> str:
    if name in _UNPORTED:
        raise NotImplementedError(
            f"tuning knob {name!r} is not ported yet: what reads it is "
            f"ROADMAP item {_UNPORTED[name]}")
    if name not in _DEFAULTS:
        raise KeyError(f"unknown tuning knob {name!r}")
    return name


_STATE = dict(_DEFAULTS)


def get(name: str):
    return _STATE[_known(name)]


def scores_dtype() -> torch.dtype:
    return torch.bfloat16 if _STATE["scores_dtype"] == "bf16" else torch.float32


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
        else:
            out[k] = v.strip()
    return out
