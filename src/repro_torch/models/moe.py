"""Mixture-of-Experts transformer (deepseek-moe-16b, kimi-k2-1t).

The port's copy of the JAX package's ``models/moe.py``, serving part and
single-device dispatch.  Fine-grained MoE with shared experts, with the
capacity-bucketed sort-dispatch pattern:

  1. router (fp32) -> top-k experts per token, renormalized weights;
  2. flatten (token, slot) pairs, sort by expert id (stable), rank within
     expert, drop beyond capacity C = ceil(T*k/E * capacity_factor);
  3. scatter tokens into an (E, C, d) buffer;
  4. batched expert SwiGLU einsum over all E experts at capacity C;
  5. gather back, unsort, combine with router weights;
  6. shared experts run as an always-on dense MLP in parallel.

A Switch-style load-balance auxiliary loss is returned alongside.

Same results as the JAX package on its CPU backend, including where an
expert overflows: JAX writes the dropped pairs (zeros) into slot C - 1
after the pair kept there, and the last write wins, so that slot holds
zeros and the token kept at rank C - 1 loses that expert's output.  The
port writes only the pairs it keeps (``dispatch``), which leaves that slot
zero: the same buffer with no duplicate writes.

The gradient agrees too: JAX's scatter passes no cotangent to an
overwritten update, and the port never writes that pair.

Not here: ``_moe_ffn_shardmap`` (the expert-parallel path over a mesh,
ROADMAP item 11d, the only reader of the ``capacity_factor`` tuning
knob).
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tuning
from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from .layers import (
    MLP, Attention, RMSNorm, _param, attention_decode, chunked_xent,
    dense_init_, mlp, rmsnorm,
)
from .transformer import (
    Cache, Layer, _attention_dyn, _embed, attn_spec, logits_fn,
)
# the family's KV cache: every layer, dense first, as the JAX package's
from .transformer import init_cache  # noqa: F401


class MoEFFN(nn.Module):
    """``router`` (d, E) float32 whatever the parameter dtype, ``w_gate`` /
    ``w_up`` (E, d, ff), ``w_down`` (E, ff, d), and ``shared`` (an MLP of
    width ff * n_shared) with shared experts."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        dt = cfg.p_dtype
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, ff), dt, device)
        self.w_up = _param((e, d, ff), dt, device)
        self.w_down = _param((e, ff, d), dt, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, ff * cfg.n_shared_experts, dt, device)

    def init_(self, gen: torch.Generator) -> None:
        d, ff = self.w_up.shape[1:]
        dense_init_(self.router, d, gen)
        dense_init_(self.w_gate, d, gen)
        dense_init_(self.w_up, d, gen)
        dense_init_(self.w_down, ff, gen)
        if hasattr(self, "shared"):
            self.shared.init_(gen)


class MoELayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = Attention(attn_spec(cfg), dt, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.moe = MoEFFN(cfg, device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.moe):
            m.init_(gen)


class MoEParams(nn.Module):
    """The JAX parameter tree as modules: ``embed`` (V, d),
    ``dense_layers`` (the first ``first_dense_layers`` blocks, dense
    ``transformer.Layer``s), ``moe_layers`` and ``ln_f``.  Embeddings are
    tied (the JAX package makes no ``unembed`` for this family)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        self.dense_layers = nn.ModuleList(
            Layer(cfg, device) for _ in range(cfg.first_dense_layers))
        self.moe_layers = nn.ModuleList(
            MoELayer(cfg, device)
            for _ in range(cfg.n_layers - cfg.first_dense_layers))


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: Device) -> MoEParams:
    """Random initialisation from ``gen``: the JAX package's distributions,
    not its draws."""
    p = MoEParams(cfg, resolve_device(device))
    dense_init_(p.embed, cfg.vocab, gen)
    p.ln_f.init_(gen)
    for layer in list(p.dense_layers) + list(p.moe_layers):
        layer.init_(gen)
    return p


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert: ceil(T*k/E * capacity_factor), rounded up to a
    multiple of 8, at least 8."""
    cap = int(math.ceil(tokens * cfg.experts_per_token / cfg.n_experts
                        * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def route(p: MoEFFN, cfg: ArchConfig, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, d) tokens -> router probabilities (T, E) and the top-k
    renormalized weights and expert ids (T, k), float32.  Ties go to the
    lower expert id, as ``lax.top_k`` breaks them (a stable descending
    sort; ``torch.topk`` keeps no order among equals)."""
    logits = xf.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, topv, topi


class Route(NamedTuple):
    """One MoE layer call's routing, for callers that compare routes:
    ``probs`` (T, E) the router's float32 probabilities, ``topi`` (T, k)
    its top-k expert ids, ``applied`` (T, k) the same with -1 where the
    pair's output is lost (past the capacity, or an overflowing expert's
    last slot)."""
    probs: torch.Tensor
    topi: torch.Tensor
    applied: torch.Tensor


def dispatch(topi: torch.Tensor, cap: int, n_experts: int):
    """(T, k) expert ids -> the sort-dispatch: ``order`` (the stable sort
    of the flat pairs by expert), the sorted experts ``se``, the pairs'
    ``rank`` within their expert, and ``kept`` (sorted order): a pair is
    kept below the capacity, except the pair at rank ``cap - 1`` of an
    expert that overflows, which the reference's scatter overwrites with a
    dropped pair's zeros (its last write to that slot wins)."""
    flat_e = topi.reshape(-1)
    n = flat_e.numel()
    dev = topi.device
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(n_experts, device=dev),
                                side="left")
    rank = torch.arange(n, device=dev) - starts[se]
    overflow = torch.bincount(flat_e, minlength=n_experts) > cap
    kept = (rank < cap) & ~((rank == cap - 1) & overflow[se])
    return order, se, rank, kept


def applied_experts(topi: torch.Tensor, cap: int,
                    n_experts: int) -> torch.Tensor:
    """(T, k) expert ids -> the same, -1 where ``dispatch`` loses the
    pair."""
    order, se, _, kept = dispatch(topi, cap, n_experts)
    return _unsort(order, torch.where(kept, se, -1)).reshape(topi.shape)


def _unsort(order: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(sorted_vals)
    out[order] = sorted_vals
    return out


def moe_ffn(p: MoEFFN, cfg: ArchConfig, x: torch.Tensor,
            routes: Optional[list] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss): the JAX package's single-device
    dispatch (``_moe_ffn_local``).  With ``routes``, appends this call's
    :class:`Route`."""
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    e = cfg.n_experts
    cap = capacity(cfg, t)
    dev = x.device

    xf = x.reshape(t, d)
    probs, topv, topi = route(p, cfg, xf)

    # ---- load-balance aux (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, topi.reshape(-1), torch.ones(t * k, device=dev)) / (t * k)
    aux = e * torch.sum(me * ce)

    # ---- sort-dispatch into (E, C, d): the kept pairs only, so a lost
    # pair's slot holds zeros, as the reference's leaves it
    order, se, rank, kept = dispatch(topi, cap, e)
    tok = (torch.arange(t * k, device=dev) // k)[order]
    if routes is not None:
        routes.append(Route(probs, topi, _unsort(
            order, torch.where(kept, se, -1)).reshape(t, k)))
    dt = xf.dtype
    buf = torch.zeros((e, cap, d), dtype=dt, device=dev)
    buf[se[kept], rank[kept]] = xf[tok[kept]]

    # ---- expert SwiGLU over all E experts at capacity C
    gate = F.silu(torch.einsum("ecd,edf->ecf", buf, p.w_gate.to(dt)))
    up = torch.einsum("ecd,edf->ecf", buf, p.w_up.to(dt))
    out_buf = torch.einsum("ecf,efd->ecd", gate * up, p.w_down.to(dt))

    # ---- return + combine (summed in the activation dtype, as JAX's
    # scatter-add)
    vals = out_buf[se, torch.clamp(rank, max=cap - 1)] * kept[:, None].to(dt)
    contrib = torch.zeros((t, d), dtype=dt, device=dev).index_add_(
        0, tok, vals * topv.reshape(-1)[order, None].to(dt))
    if hasattr(p, "shared"):
        contrib = contrib + mlp(p.shared, xf)
    return contrib.reshape(b, s, d), aux


def _layers(params: MoEParams) -> list:
    return list(params.dense_layers) + list(params.moe_layers)


def blocks(params: MoEParams, cfg: ArchConfig, tokens: torch.Tensor,
           routes: Optional[list] = None) -> List[Callable]:
    """The stack over ``tokens``' (B, S) positions, in order, each a
    function of the residual stream (B, S, d) -> (stream, aux loss): the
    dense blocks (aux 0), then the MoE blocks (``routes`` as in
    :func:`moe_ffn`)."""
    spec = attn_spec(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)

    def block(layer_p):
        def run(x):
            x = x + _attention_dyn(layer_p.attn, spec,
                                   rmsnorm(layer_p.ln1, x), positions, 0)
            h = rmsnorm(layer_p.ln2, x)
            if isinstance(layer_p, MoELayer):
                h, aux = moe_ffn(layer_p.moe, cfg, h, routes)
                return x + h, aux
            return x + mlp(layer_p.mlp, h), torch.zeros(
                (), dtype=torch.float32, device=x.device)
        return run

    return [block(lp) for lp in _layers(params)]


def forward(params: MoEParams, cfg: ArchConfig, tokens: torch.Tensor,
            routes: Optional[list] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids -> (final hidden states (B, S, d), mean aux loss).  Each
    block runs under ``tuning.remat_wrap``; ``routes``
    gets one ``Route`` per MoE layer all the same (the backward pass's
    recomputation appends to a list of its own)."""
    x = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    fresh = None if routes is None else []
    for block in blocks(params, cfg, tokens, fresh):
        x, a = tuning.remat_wrap(block)(x)
        aux = aux + a
        if fresh:
            routes.extend(fresh)
            fresh.clear()
    return rmsnorm(params.ln_f, x), aux / max(1, cfg.n_layers)


def loss_fn(params: MoEParams, cfg: ArchConfig, batch: dict,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Cross entropy (``chunked_xent``, tied embedding) plus
    ``aux_weight`` times the mean load-balance loss."""
    hidden, aux = forward(params, cfg, batch["tokens"])
    return chunked_xent(hidden, params.embed, batch["labels"]) \
        + aux_weight * aux


def hidden(params: MoEParams, cfg: ArchConfig, batch: dict,
           routes: Optional[list] = None) -> torch.Tensor:
    """The batch's final hidden states (B, S, d)."""
    return forward(params, cfg, batch["tokens"], routes)[0]


def decode_blocks(params: MoEParams, cfg: ArchConfig, cache: Cache,
                  pos: int, routes: Optional[list] = None
                  ) -> List[Callable]:
    """The stack for one decode step at ``pos``, in order, each a function
    of the stream (B, 1, d) that writes its layer's KV in ``cache``."""
    spec = attn_spec(cfg)

    def block(i, layer_p):
        def run(x):
            h, _, _ = attention_decode(layer_p.attn, spec,
                                       rmsnorm(layer_p.ln1, x),
                                       cache["k"][i], cache["v"][i], pos)
            x = x + h
            h = rmsnorm(layer_p.ln2, x)
            if isinstance(layer_p, MoELayer):
                return x + moe_ffn(layer_p.moe, cfg, h, routes)[0]
            return x + mlp(layer_p.mlp, h)
        return run

    return [block(i, lp) for i, lp in enumerate(_layers(params))]


def decode_step(params: MoEParams, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, pos: int,
                routes: Optional[list] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token MoE decode; the caches are (L, B, S, Kv, D) across *all*
    layers (dense first, then MoE layers, in order), written in place."""
    x = _embed(params, cfg, tokens)
    for block in decode_blocks(params, cfg, cache, pos, routes):
        x = block(x)
    x = rmsnorm(params.ln_f, x)
    return logits_fn(params, cfg, x[:, 0]), cache
