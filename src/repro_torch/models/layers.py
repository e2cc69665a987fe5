"""Shared neural building blocks of the dense family (serving part).

The port's copy of the JAX package's ``models/layers.py``.  Parameters sit
in small ``nn.Module``s (``RMSNorm``, ``Attention``, ``MLP``) whose
attribute names are the JAX parameter tree's keys; the computations are
plain functions on tensors with the JAX names (``rmsnorm``, ``rope``,
``attention``, ``attention_decode``, ``mlp``), taking the module where JAX
takes the parameter dict.

Conventions, as in JAX:
  * params are created in ``param_dtype`` (fp32 by default) and cast to the
    activation dtype at use — the usual mixed-precision recipe;
  * attention uses blockwise softmax over query chunks so (B, H, S, S)
    score tensors are never materialized at long sequence;
  * decode paths take a KV cache laid out (B, S_max, n_kv, head_dim) and a
    scalar position.  The cache is written in place (JAX returns a new
    one); the functions return it all the same.
  * parameters do not require grad: this is the serving path (training is
    not ported yet).

Not here: the mesh paths (``ctx.constrain``, the flash-decode shard map)
and training (``chunked_xent``, the bf16 cotangent cast).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tuning

# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(p: torch.Tensor, d_in: int, gen: torch.Generator) -> None:
    """``p`` <- normal(0, 1) / sqrt(d_in), drawn in float32 and cast, as
    JAX's ``dense_init``."""
    x = torch.randn(p.shape, generator=gen, device=p.device,
                    dtype=torch.float32)
    p.copy_(x.mul_(1.0 / math.sqrt(d_in)))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    if tuning.get("act_bf16") and dt == torch.bfloat16:
        # f32 only inside the variance reduction; the normalize/scale
        # applies in bf16
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(dt)
        return x * inv * p.scale.to(dt)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(dt)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int.  Computed in float32 and
    cast back to ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq     # (..., S, half)
    cos = torch.cos(angles)[..., None, :]             # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    # sliding window size; None = full attention.  Per-layer local/global
    # selection is handled by the caller via the `window` argument override.
    window: Optional[int] = None


class Attention(nn.Module):
    """wq (d, H, D), wk / wv (d, Kv, D), wo (H, D, d); q_norm / k_norm
    with qk-norm."""

    def __init__(self, spec: AttnSpec, dtype: torch.dtype, device):
        super().__init__()
        d, h, kvh, hd = spec.d_model, spec.n_heads, spec.n_kv, spec.head_dim
        self.wq = _param((d, h, hd), dtype, device)
        self.wk = _param((d, kvh, hd), dtype, device)
        self.wv = _param((d, kvh, hd), dtype, device)
        self.wo = _param((h, hd, d), dtype, device)
        if spec.qk_norm:
            self.q_norm = RMSNorm(hd, dtype, device)
            self.k_norm = RMSNorm(hd, dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        d, h, hd = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, d, gen)
        dense_init_(self.wo, h * hd, gen)
        if hasattr(self, "q_norm"):
            self.q_norm.init_(gen)
            self.k_norm.init_(gen)


def _qkv(p: Attention, spec: AttnSpec, x: torch.Tensor,
         positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if spec.qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    q = rope(q, positions, spec.rope_theta)
    k = rope(k, positions, spec.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Kv, D) -> (B, S, Kv*groups, D) by repeat (GQA share)."""
    if groups == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(
        b, s, kv * groups, d)


def _chunks(s: int, q_chunk: int) -> Tuple[int, int]:
    """(chunk, count) of blocks of ``q_chunk`` along a sequence of ``s``
    (attention's query blocks, the SSD and mLSTM chunks); a ragged tail
    takes one chunk of ``s``."""
    q_chunk = min(q_chunk, s)
    n_chunks = max(1, s // q_chunk)
    if n_chunks * q_chunk != s:
        return s, 1
    return q_chunk, n_chunks


def attention(
    p: Attention,
    spec: AttnSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    window: Optional[int] = None,
    q_chunk: int = 512,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Blockwise-softmax multi-head attention (training / prefill path).

    Loops over query chunks; each step materializes only a
    (B, H, q_chunk, S) score tile.  ``window`` enables sliding-window
    (local) masking; ``cross_kv`` switches to encoder-decoder cross
    attention (no causal mask, externally supplied K/V).
    """
    b, s, d = x.shape
    spec_window = window if window is not None else spec.window
    if cross_kv is None:
        q, k, v = _qkv(p, spec, x, positions)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
        if spec.qk_norm:
            q = rmsnorm(p.q_norm, q)
        k, v = cross_kv
    groups = spec.n_heads // spec.n_kv
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = 1.0 / math.sqrt(spec.head_dim)
    kv_pos = torch.arange(k.shape[1], device=x.device)
    if positions.ndim != 2:
        raise ValueError("positions must be (B, S)")
    q_chunk, n_chunks = _chunks(s, q_chunk)
    outs = []
    for c in range(n_chunks):
        q_i = q[:, c * q_chunk:(c + 1) * q_chunk]
        pos_i = positions[:, c * q_chunk:(c + 1) * q_chunk]
        scores = torch.einsum("bchk,bshk->bhcs", q_i, k).float() * scale
        if cross_kv is None and spec.causal:
            cmask = pos_i[:, None, :, None] >= kv_pos[None, None, None, :]
            if spec_window is not None:
                cmask &= (pos_i[:, None, :, None]
                          - kv_pos[None, None, None, :] < spec_window)
            scores = torch.where(cmask, scores, -1e30)
        out = torch.softmax(scores, dim=-1).to(q_i.dtype)
        outs.append(torch.einsum("bhcs,bshk->bchk", out, v))
    o = torch.cat(outs, dim=1).reshape(b, s, spec.n_heads, spec.head_dim)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(o.dtype))


def attention_decode(
    p: Attention,
    spec: AttnSpec,
    x: torch.Tensor,             # (B, 1, d)
    cache_k: torch.Tensor,       # (B, S_max, n_kv, D)
    cache_v: torch.Tensor,
    pos: int,                    # current position
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode with KV-cache append: the dense reduction over
    the cache.

    Every row of the batch writes its new K/V at ``pos``.  As
    ``jax.lax.dynamic_update_slice`` does, a ``pos`` past the end writes
    at ``S_max - 1`` (and one below 0 at 0); RoPE and the mask still use
    ``pos`` itself.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, spec, x, positions)
    at = min(max(pos, 0), cache_k.shape[1] - 1)
    cache_k[:, at] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, at] = v_new[:, 0].to(cache_v.dtype)
    groups = spec.n_heads // spec.n_kv
    k = _repeat_kv(cache_k.to(x.dtype), groups)
    v = _repeat_kv(cache_v.to(x.dtype), groups)
    scale = 1.0 / math.sqrt(spec.head_dim)
    scores = torch.einsum("bchk,bshk->bhcs", q, k).float() * scale
    kv_pos = torch.arange(k.shape[1], device=x.device)
    mask = kv_pos <= pos
    w = window if window is not None else spec.window
    if w is not None:
        mask &= kv_pos > pos - w
    scores = torch.where(mask[None, None, None, :], scores, -1e30)
    # numerically-stable softmax, written as separable (max, sum)
    mx = torch.amax(scores, dim=-1, keepdim=True)
    ex = torch.exp(scores - mx)
    den = torch.sum(ex, dim=-1, keepdim=True)
    probs = (ex / den).to(x.dtype)
    o = torch.einsum("bhcs,bshk->bchk", probs, v)
    out = torch.einsum("bshk,hkd->bsd", o, p.wo.to(o.dtype))
    return out, cache_k, cache_v


# --------------------------------------------------------------------------
# MLP (SwiGLU or GeLU)
# --------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU: w_gate, w_up (d, ff), w_down (ff, d); GeLU: no w_gate."""

    def __init__(self, d: int, ff: int, dtype: torch.dtype, device,
                 variant: str = "swiglu"):
        super().__init__()
        if variant != "gelu":
            self.w_gate = _param((d, ff), dtype, device)
        self.w_up = _param((d, ff), dtype, device)
        self.w_down = _param((ff, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        d, ff = self.w_up.shape
        if hasattr(self, "w_gate"):
            dense_init_(self.w_gate, d, gen)
        dense_init_(self.w_up, d, gen)
        dense_init_(self.w_down, ff, gen)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    w_up = p.w_up.to(dt)
    w_down = p.w_down.to(dt)
    if hasattr(p, "w_gate"):  # SwiGLU
        gate = F.silu(x @ p.w_gate.to(dt))
        return (gate * (x @ w_up)) @ w_down
    u = x @ w_up
    if tuning.get("act_bf16") and u.dtype == torch.bfloat16:
        # dtype-clean tanh gelu (python-float constants keep bf16)
        h = 0.5 * u * (1.0 + torch.tanh(0.7978845608 * (u + 0.044715 * u * u * u)))
    else:
        h = F.gelu(u, approximate="tanh")   # jax.nn.gelu's default
    return h @ w_down
