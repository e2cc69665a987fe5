"""Encoder-decoder transformer backbone (whisper-base).

The port's copy of the JAX package's ``models/encdec.py``, serving part.
The conv/mel frontend is a stub: callers supply precomputed frame
embeddings (B, T_enc, frontend_dim), which the model projects to d_model.
Encoder = bidirectional self-attention stack; decoder = causal
self-attention + cross-attention.  RoPE is used in both stacks (on the
self-attention; the cross-attention K/V carry none).  The decoder's token
embedding is not scaled by sqrt(d), as in the JAX package.

Serving: ``init_cache`` holds the self-attention KV and the cross-attention
KV (``xk`` / ``xv``, (L, B, T_enc, Kv, D)); ``prefill_cross`` fills the
latter from ``encode``'s output.  As in the JAX package, the ``Model``
facade's ``decode`` never calls it, so a ``DecodeServer`` decodes against
a zero cross-KV (the cross branch adds a uniform average of zeros, 0); the
port keeps this.

Not here: ``loss_fn`` (training).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from .layers import (
    MLP, Attention, AttnSpec, RMSNorm, _param, _repeat_kv, attention,
    attention_decode, dense_init_, mlp, rmsnorm,
)
from .transformer import attn_spec, logits_fn

Cache = Dict[str, torch.Tensor]


def _cross_spec(cfg: ArchConfig) -> AttnSpec:
    return dataclasses.replace(attn_spec(cfg), causal=False)


class EncLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = Attention(_cross_spec(cfg), dt, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device, cfg.mlp_variant)

    def init_(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init_(gen)


class DecLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = Attention(attn_spec(cfg), dt, device)
        self.ln_x = RMSNorm(cfg.d_model, dt, device)
        self.xattn = Attention(_cross_spec(cfg), dt, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device, cfg.mlp_variant)

    def init_(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init_(gen)


class EncDecParams(nn.Module):
    """The JAX parameter tree as modules: ``frontend_proj``
    (frontend_dim, d), ``enc_layers``, ``enc_ln_f``, ``embed`` (V, d),
    ``dec_layers``, ``ln_f``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.frontend_proj = _param((cfg.frontend_dim, cfg.d_model), dt,
                                    device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device)
                                        for _ in range(cfg.encoder_layers))
        self.enc_ln_f = RMSNorm(cfg.d_model, dt, device)
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, dt, device)


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: Device) -> EncDecParams:
    """Random initialisation from ``gen``: the JAX package's distributions,
    not its draws."""
    p = EncDecParams(cfg, resolve_device(device))
    dense_init_(p.frontend_proj, cfg.frontend_dim, gen)
    dense_init_(p.embed, cfg.vocab, gen)
    for m in list(p.enc_layers) + list(p.dec_layers) + [p.enc_ln_f, p.ln_f]:
        m.init_(gen)
    return p


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def encode(params: EncDecParams, cfg: ArchConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, frontend_dim) stub embeddings -> (B, T_enc, d)."""
    dt = cfg.activation_dtype
    x = frames.to(dt) @ params.frontend_proj.to(dt)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    spec = _cross_spec(cfg)
    for lp in params.enc_layers:
        x = x + attention(lp.attn, spec, rmsnorm(lp.ln1, x), positions)
        x = x + mlp(lp.mlp, rmsnorm(lp.ln2, x))
    return rmsnorm(params.enc_ln_f, x)


def _cross_kv(layer_p: DecLayer, cfg: ArchConfig, enc_out: torch.Tensor):
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, layer_p.xattn.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, layer_p.xattn.wv.to(dt))
    return k, v


def _embed_tokens(params: EncDecParams, cfg: ArchConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: the same values as JAX's cast of the whole table
    return params.embed[tokens].to(cfg.activation_dtype)


def decode_train(params: EncDecParams, cfg: ArchConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder over a whole token sequence (teacher forcing), attending
    to ``enc_out``: (B, S) ids -> final hidden states (B, S, d)."""
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = _positions(b, s, x.device)
    self_spec = attn_spec(cfg)
    x_spec = _cross_spec(cfg)
    for lp in params.dec_layers:
        x = x + attention(lp.attn, self_spec, rmsnorm(lp.ln1, x), positions)
        kv = _cross_kv(lp, cfg, enc_out)
        x = x + attention(lp.xattn, x_spec, rmsnorm(lp.ln_x, x), positions,
                          cross_kv=kv)
        x = x + mlp(lp.mlp, rmsnorm(lp.ln2, x))
    return rmsnorm(params.ln_f, x)


def hidden(params: EncDecParams, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The decoder's final hidden states (B, S, d) over the batch's
    ``tokens``, attending to ``encode`` of its ``frames``."""
    return decode_train(params, cfg, batch["tokens"],
                        encode(params, cfg, batch["frames"]))


# ------------------------------------------------------------------ serving

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device: Device = "cuda") -> Cache:
    dt = dtype or cfg.activation_dtype
    device = resolve_device(device)
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    # cross-attention KV, filled once from the encoder output
    xkv = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "xk": torch.zeros(xkv, dtype=dt, device=device),
            "xv": torch.zeros(xkv, dtype=dt, device=device)}


def prefill_cross(params: EncDecParams, cfg: ArchConfig,
                  enc_out: torch.Tensor, cache: Cache) -> Cache:
    """Write every decoder layer's cross-attention K/V of ``enc_out``
    (B, T_enc, d) into ``cache`` in place; returns it."""
    for i, lp in enumerate(params.dec_layers):
        cache["xk"][i], cache["xv"][i] = _cross_kv(lp, cfg, enc_out)
    return cache


def decode_step(params: EncDecParams, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode against the self-attention cache (written in
    place) and the cross-attention KV in the cache."""
    x = _embed_tokens(params, cfg, tokens)
    self_spec = attn_spec(cfg)
    groups = cfg.n_heads // cfg.n_kv_heads
    for i, lp in enumerate(params.dec_layers):
        h, _, _ = attention_decode(lp.attn, self_spec, rmsnorm(lp.ln1, x),
                                   cache["k"][i], cache["v"][i], pos)
        x = x + h
        # cross attention over the (static) encoder KV, inline as in JAX
        h = rmsnorm(lp.ln_x, x)
        dt = h.dtype
        q = torch.einsum("bsd,dhk->bshk", h, lp.xattn.wq.to(dt))
        k = _repeat_kv(cache["xk"][i].to(dt), groups)
        v = _repeat_kv(cache["xv"][i].to(dt), groups)
        scores = torch.einsum("bchk,bshk->bhcs", q, k).float()
        scores = scores / math.sqrt(self_spec.head_dim)
        probs = torch.softmax(scores, dim=-1).to(dt)
        o = torch.einsum("bhcs,bshk->bchk", probs, v)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp.xattn.wo.to(dt))
        x = x + mlp(lp.mlp, rmsnorm(lp.ln2, x))
    x = rmsnorm(params.ln_f, x)
    return logits_fn(params, cfg, x[:, 0]), cache
