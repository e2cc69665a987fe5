"""Dense decoder-only transformer (qwen3 / starcoder2 / gemma3 / phi3-vision).

The port's copy of the JAX package's ``models/transformer.py``, serving
part.  One implementation covers the whole dense family:
  * GQA attention with optional qk-norm (qwen3) and RoPE;
  * per-layer local/global attention pattern (gemma3's 5:1 sliding window)
    as a per-layer window (0 = full attention);
  * optional patch-embedding frontend stub (phi-3-vision): precomputed
    patch embeddings are projected and replace the first positions.

Parameters are a ``DenseParams`` module whose layers sit in an
``nn.ModuleList``; the layer stack runs as a Python loop where JAX scans
over parameters stacked on a leading layer axis.  Not ported yet:
``loss_fn`` (training).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import tuning
from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from .layers import (
    MLP, Attention, AttnSpec, RMSNorm, _chunks, _param, _qkv, _repeat_kv,
    attention_decode, dense_init_, mlp, rmsnorm,
)

Cache = Dict[str, torch.Tensor]


def attn_spec(cfg: ArchConfig) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window,
    )


def layer_windows(cfg: ArchConfig) -> Tuple[int, ...]:
    """Per-layer sliding-window sizes; 0 = full attention.

    gemma3: `local_global_ratio` local layers then 1 global, repeating.
    """
    if cfg.sliding_window is None:
        return (0,) * cfg.n_layers
    if not cfg.local_global_ratio:
        return (cfg.sliding_window,) * cfg.n_layers
    r = cfg.local_global_ratio
    return tuple(0 if (i % (r + 1)) == r else cfg.sliding_window
                 for i in range(cfg.n_layers))


class Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = Attention(attn_spec(cfg), dt, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device, cfg.mlp_variant)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.init_(gen)


class DenseParams(nn.Module):
    """The JAX parameter tree as modules: ``embed`` (V, d), ``layers``,
    ``ln_f``, and ``unembed`` (V, d) when embeddings are untied,
    ``patch_proj`` (frontend_dim, d) with the patch frontend.  Allocated
    uninitialised; ``init_params`` draws them, ``models/convert.py`` copies
    them from the JAX package."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(Layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.vocab, cfg.d_model), dt, device)
        if cfg.frontend == "patch":
            self.patch_proj = _param((cfg.frontend_dim, cfg.d_model), dt,
                                     device)


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: Device) -> DenseParams:
    """Random initialisation from ``gen`` (a generator on ``device``): the
    JAX package's distributions (normal scaled by 1/sqrt(fan-in), norms at
    one), not its draws."""
    p = DenseParams(cfg, resolve_device(device))
    dense_init_(p.embed, cfg.vocab, gen)
    for layer in p.layers:
        layer.init_(gen)
    p.ln_f.init_(gen)
    if hasattr(p, "unembed"):
        dense_init_(p.unembed, cfg.vocab, gen)
    if hasattr(p, "patch_proj"):
        dense_init_(p.patch_proj, cfg.frontend_dim, gen)
    return p


def _embed(params: DenseParams, cfg: ArchConfig, tokens: torch.Tensor,
           patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    # gather, then cast: the same values as JAX's cast of the whole table
    x = params.embed[tokens].to(cfg.activation_dtype)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    if patch_embeds is not None and hasattr(params, "patch_proj"):
        proj = patch_embeds.to(x.dtype) @ params.patch_proj.to(x.dtype)
        # patch tokens replace the first P positions (the prompt's image slots)
        pcount = proj.shape[1]
        x = torch.cat([proj, x[:, pcount:]], dim=1)
    return x


def _layer_fwd(cfg: ArchConfig, x, layer_p: Layer, window: int, positions):
    spec = attn_spec(cfg)
    h = rmsnorm(layer_p.ln1, x)
    h = _attention_dyn(layer_p.attn, spec, h, positions, window)
    x = x + h
    h = rmsnorm(layer_p.ln2, x)
    return x + mlp(layer_p.mlp, h)


def _scores(eq: str, a: torch.Tensor, b: torch.Tensor,
            sdt: torch.dtype) -> torch.Tensor:
    """``einsum`` born in ``sdt``, as JAX's ``preferred_element_type``:
    f32 scores of bf16 operands are their exact products summed in f32;
    bf16 scores of f32 operands are f32 sums rounded to bf16."""
    if a.dtype == sdt:
        return torch.einsum(eq, a, b)
    if sdt == torch.float32:
        return torch.einsum(eq, a.float(), b.float())
    return torch.einsum(eq, a, b).to(sdt)


def _attention_dyn(p: Attention, spec: AttnSpec, x, positions, window: int):
    """Prefill attention with a per-layer window (0 = unlimited), chunked
    over queries by the ``q_chunk`` knob, scores in the ``scores_dtype``
    knob's type, and with ``gqa_native`` scored against the Kv heads."""
    b, s, d = x.shape
    sdt = tuning.scores_dtype()

    q, k, v = _qkv(p, spec, x, positions)
    groups = spec.n_heads // spec.n_kv
    gqa_native = tuning.get("gqa_native") and groups > 1
    if not gqa_native:
        k = _repeat_kv(k, groups)
        v = _repeat_kv(v, groups)
    scale = 1.0 / math.sqrt(spec.head_dim)
    kv_pos = torch.arange(k.shape[1], device=x.device)
    q_chunk, n_chunks = _chunks(s, tuning.get("q_chunk"))
    eff_window = window if window > 0 else 2 ** 30
    neg = -30000.0 if sdt == torch.bfloat16 else -1e30

    def one_chunk(q_i, pos_i):
        # scale folded into q; softmax normalization applied to the
        # output, not the (c, S) probability tile
        qs_ = q_i * torch.tensor(scale, dtype=q_i.dtype, device=q_i.device)
        if gqa_native:
            # score einsum against the Kv heads directly: repeated K/V are
            # never materialized
            b_, c_, H_, D_ = qs_.shape
            qg = qs_.reshape(b_, c_, spec.n_kv, groups, D_)
            scores = _scores("bckgd,bskd->bkgcs", qg, k, sdt)
            delta = (pos_i[:, None, None, :, None]
                     - kv_pos[None, None, None, None, :])
            cmask = (delta >= 0) & (delta < eff_window)
            scores = torch.where(cmask, scores, neg)
            mx = torch.amax(scores, dim=-1, keepdim=True)
            ex = torch.exp(scores - mx)
            den = torch.sum(ex, dim=-1)                   # (B,Kv,G,c)
            o = torch.einsum("bkgcs,bskd->bckgd", ex.to(q_i.dtype), v)
            o = o / torch.movedim(den, 3, 1)[..., None].to(o.dtype)
            return o.reshape(b_, c_, H_, D_)
        scores = _scores("bchk,bshk->bhcs", qs_, k, sdt)
        delta = pos_i[:, None, :, None] - kv_pos[None, None, None, :]
        cmask = (delta >= 0) & (delta < eff_window)
        scores = torch.where(cmask, scores, neg)
        mx = torch.amax(scores, dim=-1, keepdim=True)
        ex = torch.exp(scores - mx)
        den = torch.sum(ex, dim=-1)                       # (B,H,c)
        o = torch.einsum("bhcs,bshk->bchk", ex.to(q_i.dtype), v)
        return o / torch.swapaxes(den, 1, 2)[..., None].to(o.dtype)

    o = torch.cat([one_chunk(q[:, c * q_chunk:(c + 1) * q_chunk],
                             positions[:, c * q_chunk:(c + 1) * q_chunk])
                   for c in range(n_chunks)], dim=1)
    o = o.reshape(b, s, spec.n_heads, spec.head_dim)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(o.dtype))


def forward(params: DenseParams, cfg: ArchConfig, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids -> final hidden states (B, S, d)."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, patch_embeds)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    for layer_p, win in zip(params.layers, layer_windows(cfg)):
        x = _layer_fwd(cfg, x, layer_p, win, positions)
    return rmsnorm(params.ln_f, x)


def hidden(params: DenseParams, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The batch's final hidden states (B, S, d) (``patch_embeds`` for the
    patch frontend)."""
    return forward(params, cfg, batch["tokens"], batch.get("patch_embeds"))


def logits_fn(params: DenseParams, cfg: ArchConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    emb = getattr(params, "unembed", params.embed)
    return hidden @ emb.to(hidden.dtype).T


# ---------------------------------------------------------------- serving

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device: Device = "cuda") -> Cache:
    dt = dtype or cfg.activation_dtype
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_step(params: DenseParams, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode: (B, 1) tokens at position `pos` -> (B, V) logits.

    The cache is written in place and returned."""
    x = _embed(params, cfg, tokens)
    spec = attn_spec(cfg)
    for i, (layer_p, win) in enumerate(zip(params.layers, layer_windows(cfg))):
        h = rmsnorm(layer_p.ln1, x)
        # per-layer window; 0 = full attention
        w = win if win > 0 else 2 ** 30
        h, _, _ = attention_decode(layer_p.attn, spec, h, cache["k"][i],
                                   cache["v"][i], pos, window=w)
        x = x + h
        h = rmsnorm(layer_p.ln2, x)
        x = x + mlp(layer_p.mlp, h)
    x = rmsnorm(params.ln_f, x)
    return logits_fn(params, cfg, x[:, 0]), cache
