"""Shared neural building blocks of every architecture in the pool.

The port's copy of the JAX package's ``models/layers.py``.  Parameters sit
in small ``nn.Module``s (``RMSNorm``, ``Attention``, ``MLP``) whose
attribute names are the JAX parameter tree's keys; the computations are
plain functions on tensors with the JAX names (``rmsnorm``, ``rope``,
``attention``, ``attention_decode``, ``mlp``, ``chunked_xent``), taking
the module where JAX takes the parameter dict.

Conventions, as in JAX:
  * params are created in ``param_dtype`` (fp32 by default) and cast to the
    activation dtype at use — the usual mixed-precision recipe;
  * attention uses blockwise softmax over query chunks so (B, H, S, S)
    score tensors are never materialized at long sequence;
  * decode paths take a KV cache laid out (B, S_max, n_kv, head_dim) and a
    scalar position.  The cache is written in place (JAX returns a new
    one); the functions return it all the same.
  * parameters are made with ``requires_grad=False``, so serving builds no
    autograd graph; the train step (``train/step.py``) turns it on for its
    backward pass and off again.

The mesh paths are here too: ``ctx.constrain`` where the reference
constrains (a described layout; the port returns the tensor itself), and
the flash decode (``_attention_decode_flash``), which ``attention_decode``
takes under the ``flash_decode`` knob and an active mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tuning
from ..parallel import collectives as coll
from ..parallel import ctx

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
        return x * inv * p.scale.to(x.device, dt)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.to(x.device, torch.float32)).to(dt)


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
    wq = ctx.constrain(p.wq.to(dt), (None, "model", None))
    wk = ctx.constrain(p.wk.to(dt), (None, "model", None))
    wv = ctx.constrain(p.wv.to(dt), (None, "model", None))
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
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
    wo = ctx.constrain(p.wo.to(o.dtype), ("model", None, None))
    return torch.einsum("bshk,hkd->bsd", o, wo)


def attention_decode(
    p: Attention,
    spec: AttnSpec,
    x: torch.Tensor,             # (B, 1, d)
    cache_k: torch.Tensor,       # (B, S_max, n_kv, D)
    cache_v: torch.Tensor,
    pos: int,                    # current position
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode with KV-cache append.

    Default path: the dense reduction over the cache.  Every row of the
    batch writes its new K/V at ``pos``.  As ``jax.lax.dynamic_update_slice``
    does, a ``pos`` past the end writes at ``S_max - 1`` (and one below 0
    at 0); RoPE and the mask still use ``pos`` itself.  With the
    ``flash_decode`` knob and an active mesh that fits
    (``_flash_applicable``), ``_attention_decode_flash`` instead.
    """
    mesh = ctx.current_mesh()
    if (tuning.get("flash_decode") and mesh is not None
            and _flash_applicable(x, cache_k, mesh)):
        return _attention_decode_flash(p, spec, x, cache_k, cache_v, pos,
                                       window, mesh)
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
    wo = ctx.constrain(p.wo.to(o.dtype), ("model", None, None))
    out = torch.einsum("bshk,hkd->bsd", o, wo)
    return out, cache_k, cache_v


def _flash_applicable(x: torch.Tensor, cache_k: torch.Tensor, mesh) -> bool:
    m = mesh.shape.get("model", 1)
    dp = math.prod(mesh.shape[a] for a in ctx.dp_axes(mesh))
    return (cache_k.shape[1] % m == 0 and x.shape[0] % dp == 0
            and "model" in mesh.axis_names)


def _attention_decode_flash(p: Attention, spec: AttnSpec, x: torch.Tensor,
                            cache_k: torch.Tensor, cache_v: torch.Tensor,
                            pos: int, window: Optional[int], mesh):
    """Flash decoding over the mesh, the reference's ``shard_map`` written
    as stages between collectives (``parallel/collectives.py``).

    The cache is split along the sequence over ``model`` (``s_loc`` rows a
    shard) and along the batch over the data axes; it stays whole on its
    device, and each coordinate reads its block.  Only the shard whose rows
    hold ``pos`` writes the new K/V (at ``pos - base``; a ``pos`` outside
    the cache is written by no shard).  Each shard computes masked partial
    softmax statistics (max, numerator, denominator); a ``pmax`` and two
    ``psum``s over ``model`` with the ``exp(mx_l - mx_g)`` correction give
    the exact softmax, so no shard reads another's cache rows.

    The reference's order of rounding, which differs from the dense path:
    ``q * scale`` is cast to the query dtype before the score product,
    scores are float32, the exponentials are cast to the query dtype
    before the value product, and the numerator is rescaled and summed in
    that dtype."""
    b = x.shape[0]
    s_max = cache_k.shape[1]
    m_sz = mesh.shape["model"]
    s_loc = s_max // m_sz
    dp = ctx.dp_axes(mesh)
    b_l = b // math.prod(mesh.shape[a] for a in dp)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, spec, x, positions)
    groups = spec.n_heads // spec.n_kv
    scale = 1.0 / math.sqrt(spec.head_dim)
    w = window if window is not None else spec.window

    def rows(c):
        r = coll.index_along(mesh, c, dp)
        return slice(r * b_l, (r + 1) * b_l)

    def partial(c, dev):
        base = coll.index_along(mesh, c, "model") * s_loc
        r = rows(c)
        ck, cv = cache_k[r, base:base + s_loc], cache_v[r, base:base + s_loc]
        if base <= pos < base + s_loc:         # the owning shard writes
            ck[:, pos - base] = k_new[r, 0].to(ck.dtype)
            cv[:, pos - base] = v_new[r, 0].to(cv.dtype)
        q_l = q[r].to(dev)
        k = _repeat_kv(ck.to(dev, q_l.dtype), groups)
        v = _repeat_kv(cv.to(dev, q_l.dtype), groups)
        qs = q_l * torch.tensor(scale, dtype=q_l.dtype, device=dev)
        scores = torch.einsum("bchk,bshk->bhcs", qs.float(), k.float())
        kv_pos = base + torch.arange(s_loc, device=dev)
        mask = kv_pos <= pos
        if w is not None:
            mask &= kv_pos > pos - w
        scores = torch.where(mask[None, None, None, :], scores, -1e30)
        mx_l = torch.amax(scores, dim=-1)                  # (B, H, 1)
        ex = torch.exp(scores - mx_l[..., None])
        den_l = torch.sum(ex, dim=-1)
        num_l = torch.einsum("bhcs,bshk->bchk", ex.to(q_l.dtype), v)
        return mx_l, den_l, num_l

    mx_l, den_l, num_l = coll.run(mesh, partial)
    mx_g = coll.pmax(mesh, mx_l, "model")

    def rescale(c, dev, mx, mx_all, den, num):
        corr = torch.exp(mx - mx_all)                      # (B, H, 1)
        return (num * torch.swapaxes(corr, 1, 2)[..., None].to(num.dtype),
                den * corr)

    num, den = coll.run(mesh, rescale, mx_l, mx_g, den_l, num_l)
    num, den = coll.psum(mesh, num, "model"), coll.psum(mesh, den, "model")
    o = coll.run(mesh, lambda c, dev, n, d: n / torch.swapaxes(d, 1, 2)[
        ..., None].to(n.dtype), num, den)
    # out: batch blocks over the data axes, replicated over `model`
    o = torch.cat([o[c].to(x.device) for c in coll.coords(mesh)
                   if coll.index_along(mesh, c, "model") == 0], dim=0)
    o = o.reshape(b, 1, spec.n_heads, spec.head_dim)
    wo = ctx.constrain(p.wo.to(o.dtype), ("model", None, None))
    out = torch.einsum("bshk,hkd->bsd", o, wo)
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
    w_up = ctx.constrain(p.w_up.to(dt), (None, "model"))
    w_down = ctx.constrain(p.w_down.to(dt), ("model", None))
    w_gate = None
    if hasattr(p, "w_gate"):  # SwiGLU
        w_gate = ctx.constrain(p.w_gate.to(dt), (None, "model"))
    return mlp_apply(x, w_gate, w_up, w_down)


def mlp_apply(x: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """``mlp`` on weights already cast (SwiGLU, or GeLU where ``w_gate`` is
    None); a tensor-parallel shard passes its hidden columns and gets its
    partial sum."""
    if w_gate is not None:
        gate = F.silu(x @ w_gate)
        return (gate * (x @ w_up)) @ w_down
    u = x @ w_up
    if tuning.get("act_bf16") and u.dtype == torch.bfloat16:
        # dtype-clean tanh gelu (python-float constants keep bf16)
        h = 0.5 * u * (1.0 + torch.tanh(0.7978845608 * (u + 0.044715 * u * u * u)))
    else:
        h = F.gelu(u, approximate="tanh")   # jax.nn.gelu's default
    return h @ w_down


def run_groups(x: torch.Tensor, blocks: List[Callable],
               size: int) -> torch.Tensor:
    """``blocks`` (functions of the residual stream) applied in order,
    ``size`` at a time as one unit, each unit under
    ``tuning.remat_wrap``: where JAX's scan body holds several blocks, the
    port checkpoints them together."""
    for i in range(0, len(blocks), size):
        def unit(x, group=blocks[i:i + size]):
            for block in group:
                x = block(x)
            return x
        x = tuning.remat_wrap(unit)(x)
    return x


# --------------------------------------------------------------------------
# sequence-chunked softmax cross entropy
# --------------------------------------------------------------------------


class _CtCastBf16(torch.autograd.Function):
    """Identity whose incoming cotangent is cast to bf16 — pins the whole
    backward residual chain to bf16 instead of the f32 the loss emits."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(torch.bfloat16)


def _ct_cast_bf16(x: torch.Tensor) -> torch.Tensor:
    return _CtCastBf16.apply(x)


def _xent_chunk_sum(h: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                    z_loss: float) -> torch.Tensor:
    """One chunk's summed ``nll + z_loss * lse**2``, float32: h (B, c, d),
    emb (V, d), labels (B, c) of any integer dtype (JAX's batches are
    int32; the gather widens them to int64, the index dtype it takes)."""
    logits = (h @ emb.to(h.dtype).T).float()                  # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    return torch.sum(lse - true + z_loss * lse * lse)


def chunked_xent(
    hidden: torch.Tensor,     # (B, S, d)
    emb: torch.Tensor,        # (V, d) — tied output embedding
    labels: torch.Tensor,     # (B, S) int
    z_loss: float = 1e-4,
) -> torch.Tensor:
    """Mean next-token cross entropy without materializing (B, S, V).

    Loops over sequence chunks of the ``xent_chunk`` knob (one chunk of S
    where it does not divide S); each chunk runs under a checkpoint, so its (B, c, V)
    logits live only transiently, forward and backward.  The logits are
    ``h @ emb.T`` in the activation dtype, then float32 (in bf16 the
    product is rounded before the cast, as in JAX).  The small z-loss
    regularizes the softmax normalizer.  Chunk sums accumulate in float32,
    in order, and the total is divided by B * S."""
    if tuning.get("grad_bf16") and hidden.dtype == torch.bfloat16:
        hidden = _ct_cast_bf16(hidden)
    b, s, _ = hidden.shape
    c, n = _chunks(s, tuning.get("xent_chunk"))
    emb = ctx.constrain(emb, ("model", None))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        part = checkpoint(_xent_chunk_sum, hidden[:, i * c:(i + 1) * c], emb,
                          labels[:, i * c:(i + 1) * c], z_loss,
                          use_reentrant=False)
        total = total + part
    return total / (b * s)
