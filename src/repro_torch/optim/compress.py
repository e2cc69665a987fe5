"""Gradient compression with error feedback (int8 row-scaled quantization).

The port's copy of the JAX package's ``optim/compress.py``.  Quantizing an
all-reduce payload to int8 cuts its traffic 4x against float32; the
residual (quantization error) is fed back into the next step's gradient,
so the *accumulated* update is unbiased (error-feedback SGD).  Rows are
the leading axis of each tensor given, as in JAX (a stacked JAX leaf's
rows are its layers; ``models/convert.py::named_to_numpy`` stacks the
port's).  ``torch.round`` rounds half to even, as ``jnp.round`` does, so
the payloads are bit-identical to JAX's.

Trees are dicts (nested or flat) of tensors:
    q, scale = quantize(grad)
    # all-reduce q (int8) + scale (f32 per row) instead of the raw grad
    g_hat = dequantize(q, scale)
    residual = grad - g_hat       # carried to the next step per leaf
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def _map(fn: Callable, *trees) -> Any:
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-scaled symmetric int8: scale = max|g| per leading row."""
    gf = g.float()
    flat = gf.reshape(gf.shape[0], -1) if gf.ndim > 1 else gf.reshape(1, -1)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.reshape(g.shape if g.ndim > 1 else (-1,)), scale.squeeze(-1)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qf = q.float()
    if qf.ndim > 1:
        return (qf.reshape(qf.shape[0], -1) * scale[:, None]).reshape(q.shape)
    return qf * scale


def compress_tree(grads: Any, residuals: Any) -> Tuple[Any, Any, Any]:
    """Error-feedback compression over a gradient tree.

    Returns (quantized payloads, scales, new residuals).  The caller
    transports (q, scale) over the slow axis and applies
    ``decompress_tree`` on the other side; residuals stay local."""
    def one(g, r):
        corrected = g.float() + r
        q, s = quantize(corrected)
        return q, s, corrected - dequantize(q, s)

    out = _map(one, grads, residuals)
    return tuple(_pick(out, i) for i in range(3))


def _pick(tree, i: int) -> Any:
    """The ``i``-th item of every (q, s, r) leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def decompress_tree(qs: Any, ss: Any) -> Any:
    return _map(dequantize, qs, ss)


def zero_residuals(params: Any) -> Any:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compression_ratio(grads: Any) -> float:
    """Wire-byte ratio of (int8 payload + f32 row scales) vs raw fp32."""
    leaves = _leaves(grads)
    numel = sum(x.numel() for x in leaves)
    s_bytes = sum((x.shape[0] if x.ndim > 1 else 1) * 4 for x in leaves)
    return (numel + s_bytes) / max(1, numel * 4)
