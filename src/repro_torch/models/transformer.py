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
over parameters stacked on a leading layer axis.  Each layer runs under
``tuning.remat_wrap`` (the ``remat`` knob's activation checkpointing,
as JAX's scan body) when gradients are on.
``loss_fn`` is the training objective: ``chunked_xent`` of the final
hidden states against the (tied or separate) output embedding.

Under the ``seq_shard_mlp`` knob and an active mesh (``seq_spec``), the
stream between layers is Megatron-style sequence parallel, as the
reference constrains it to ``(DP, "model", None)``: a grid of (B/dp,
S/M, d) blocks, one a coordinate on its device (``ctx.shard``), and each
layer tensor parallel over ``model`` as stages between collectives
(``_layer_stages``): an all-gather of the normed blocks before the
column-parallel products, a reduce-scatter of the row-parallel partial
sums after them.  The values are the global route's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import tuning
from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from ..parallel import ctx
from ..parallel import collectives as coll
from .layers import (
    MLP, Attention, AttnSpec, RMSNorm, _chunks, _param, _qkv, _repeat_kv,
    attention_decode, chunked_xent, dense_init_, mlp, mlp_apply, rmsnorm,
    rope,
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
    emb = ctx.constrain(params.embed, ("model", None))
    x = emb[tokens].to(cfg.activation_dtype)
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
    """Prefill attention with a per-layer window (0 = unlimited): the
    projections, ``_attend`` and the output projection."""
    q, k, v = _qkv(p, spec, x, positions)
    o = _attend(q, k, v, positions, window)
    wo = ctx.constrain(p.wo.to(o.dtype), ("model", None, None))
    return torch.einsum("bshk,hkd->bsd", o, wo)


def _attend(q, k, v, positions, window: int) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over k and v (B, S, Kv, D), query
    head h reading KV head h // (H / Kv), -> (B, S, H, D): chunked over
    queries by the ``q_chunk`` knob, scores in the ``scores_dtype`` knob's
    type, and with ``gqa_native`` scored against the Kv heads."""
    b, s, n_heads, head_dim = q.shape
    sdt = tuning.scores_dtype()
    groups = n_heads // k.shape[2]
    gqa_native = tuning.get("gqa_native") and groups > 1
    if not gqa_native:
        k = _repeat_kv(k, groups)
        v = _repeat_kv(v, groups)
    scale = 1.0 / math.sqrt(head_dim)
    kv_pos = torch.arange(k.shape[1], device=q.device)
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
            qg = qs_.reshape(b_, c_, H_ // groups, groups, D_)
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
    return o.reshape(b, s, n_heads, head_dim)


# ------------------------------------------------- the seq_shard_mlp route

def seq_spec(shape) -> Optional[ctx.PartitionSpec]:
    """The residual stream's resolved spec under the ``seq_shard_mlp`` knob
    (JAX's ``constrain(x, (DP, "model", None))`` between layers) when it
    splits the sequence over a ``model`` axis of more than one peer; None
    where the stream stays whole: the knob off, no mesh, or S not
    divisible by the axis, where ``resolve`` drops it."""
    mesh = ctx.current_mesh()
    if (not tuning.get("seq_shard_mlp") or mesh is None
            or mesh.shape.get("model", 1) == 1):
        return None
    spec = ctx.resolve(shape, (ctx.DP, "model", None), mesh)
    return spec if spec[1] == "model" else None


def _share(mesh, c: coll.Coord, n: int, split: bool) -> Tuple[int, int]:
    """Coordinate ``c``'s range of ``n`` heads or columns: its 1/M over
    ``model`` where the weight's spec splits them, else all of them (the
    reference's rule: an axis that does not divide is dropped and the
    weight replicated)."""
    if not split:
        return 0, n
    step = n // mesh.shape["model"]
    i = coll.index_along(mesh, c, "model")
    return i * step, (i + 1) * step


def _gathered(mesh, grid: coll.Grid, norm: RMSNorm) -> coll.Grid:
    """Each sequence block normed, then all-gathered over ``model``: every
    coordinate's (B/dp, S, d) rows."""
    h = coll.run(mesh, lambda c, dev, x: rmsnorm(norm, x), grid)
    return coll.all_gather(mesh, h, "model", dim=1)


def _to_rows(mesh, grid: coll.Grid, partial: bool) -> coll.Grid:
    """(B/dp, S, d) blocks back to (B/dp, S/M, d): partial sums over
    ``model`` reduce-scattered, or each coordinate's own rows of a whole
    result."""
    if partial:
        return coll.psum_scatter(mesh, grid, "model", dim=1)

    def rows(c, dev, y):
        n = y.shape[1] // mesh.shape["model"]
        return y.narrow(1, coll.index_along(mesh, c, "model") * n, n)
    return coll.run(mesh, rows, grid)


def _residual(mesh, grid: coll.Grid, delta: coll.Grid) -> coll.Grid:
    return coll.run(mesh, lambda c, dev, x, y: x + y, grid, delta)


def attention_stages(cfg: ArchConfig, mesh, grid: coll.Grid, norm: RMSNorm,
                     p: Attention, positions, window: int) -> coll.Grid:
    """A layer's attention half on a grid of sequence blocks (B/dp, S/M,
    d): norm, all-gather over ``model``, each coordinate's heads (``wq``
    and ``wo`` split by their resolved specs; ``wk`` / ``wv`` too, or
    computed whole where their spec drops ``model``, each local query head
    reading its KV group), the partial output projection reduce-scattered
    back to sequence blocks, and the residual add."""
    spec = attn_spec(cfg)
    g = spec.n_heads // spec.n_kv
    heads_split = ctx.resolve(p.wq.shape, (None, "model", None),
                              mesh)[1] is not None
    kv_split = ctx.resolve(p.wk.shape, (None, "model", None),
                           mesh)[1] is not None

    def stage(c, dev, x):
        dt = x.dtype
        h_lo, h_hi = _share(mesh, c, spec.n_heads, heads_split)
        kv_lo, kv_hi = h_lo // g, (h_hi - 1) // g + 1
        kv = slice(kv_lo, kv_hi) if kv_split else slice(None)
        q = torch.einsum("bsd,dhk->bshk", x, p.wq[:, h_lo:h_hi].to(dev, dt))
        k = torch.einsum("bsd,dhk->bshk", x, p.wk[:, kv].to(dev, dt))
        v = torch.einsum("bsd,dhk->bshk", x, p.wv[:, kv].to(dev, dt))
        if spec.qk_norm:
            q = rmsnorm(p.q_norm, q)
            k = rmsnorm(p.k_norm, k)
        pos = positions[:x.shape[0]].to(dev)     # every row is 0..S-1
        q = rope(q, pos, spec.rope_theta)
        k = rope(k, pos, spec.rope_theta)
        if not kv_split:
            k, v = k[:, :, kv_lo:kv_hi], v[:, :, kv_lo:kv_hi]
        # _attend reads KV head j // (H_l / Kv_l) for local query head j;
        # where the local heads' groups do not line up so, give each its own
        want = [(h_lo + j) // g - kv_lo for j in range(h_hi - h_lo)]
        per = (h_hi - h_lo) // (kv_hi - kv_lo)
        if want != [j // per for j in range(h_hi - h_lo)]:
            idx = torch.tensor(want, device=dev)
            k, v = k[:, :, idx], v[:, :, idx]
        o = _attend(q, k, v, pos, window)
        return torch.einsum("bshk,hkd->bsd", o,
                            p.wo[h_lo:h_hi].to(dev, dt))

    h = coll.run(mesh, stage, _gathered(mesh, grid, norm))
    return _residual(mesh, grid, _to_rows(mesh, h, heads_split))


def mlp_cols(p: MLP, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``mlp`` of hidden columns ``lo:hi`` only (a tensor-parallel shard's
    partial sum), its weights moved to ``x``'s device."""
    dt, dev = x.dtype, x.device
    w_gate = (p.w_gate[:, lo:hi].to(dev, dt) if hasattr(p, "w_gate")
              else None)
    return mlp_apply(x, w_gate, p.w_up[:, lo:hi].to(dev, dt),
                     p.w_down[lo:hi].to(dev, dt))


def mlp_stages(mesh, grid: coll.Grid, norm: RMSNorm, p: MLP) -> coll.Grid:
    """A layer's MLP half on a grid of sequence blocks: norm, all-gather
    over ``model``, each coordinate's ``ff/M`` columns of ``w_gate`` /
    ``w_up`` and rows of ``w_down`` (all of them where the spec drops
    ``model``), reduce-scatter, and the residual add."""
    ff = p.w_up.shape[1]
    split = ctx.resolve(p.w_up.shape, (None, "model"), mesh)[1] is not None

    def stage(c, dev, x):
        return mlp_cols(p, x, *_share(mesh, c, ff, split))

    h = coll.run(mesh, stage, _gathered(mesh, grid, norm))
    return _residual(mesh, grid, _to_rows(mesh, h, split))


def _layer_stages(cfg: ArchConfig, mesh, grid: coll.Grid, layer_p: Layer,
                  window: int, positions) -> coll.Grid:
    """``_layer_fwd`` on a grid of sequence blocks (B/dp, S/M, d), tensor
    parallel over ``model``: 2 all-gathers and 2 reduce-scatters."""
    grid = attention_stages(cfg, mesh, grid, layer_p.ln1, layer_p.attn,
                            positions, window)
    return mlp_stages(mesh, grid, layer_p.ln2, layer_p.mlp)


def forward(params: DenseParams, cfg: ArchConfig, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids -> final hidden states (B, S, d); each layer under
    ``tuning.remat_wrap``.  Where ``seq_spec`` splits the stream, it is
    cut into that grid of sequence blocks (``ctx.shard``), every layer
    runs as ``_layer_stages``, and the blocks are joined before ``ln_f``."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, patch_embeds)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    spec = seq_spec(x.shape)
    if spec is not None:
        mesh = ctx.current_mesh()

        def staged(grid, layer_p, win):
            return _layer_stages(cfg, mesh, grid, layer_p, win, positions)

        staged = tuning.remat_wrap(staged)
        grid = ctx.shard(x, spec)
        for layer_p, win in zip(params.layers, layer_windows(cfg)):
            grid = staged(grid, layer_p, win)
        return rmsnorm(params.ln_f, ctx.unshard(grid, spec))

    def body(x, layer_p, win):
        return _layer_fwd(cfg, x, layer_p, win, positions)

    body = tuning.remat_wrap(body)
    for layer_p, win in zip(params.layers, layer_windows(cfg)):
        x = body(x, layer_p, win)
    return rmsnorm(params.ln_f, x)


def hidden(params: DenseParams, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The batch's final hidden states (B, S, d) (``patch_embeds`` for the
    patch frontend)."""
    return forward(params, cfg, batch["tokens"], batch.get("patch_embeds"))


def logits_fn(params: DenseParams, cfg: ArchConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    emb = getattr(params, "unembed", params.embed)
    emb = ctx.constrain(emb.to(hidden.dtype), ("model", None))
    return hidden @ emb.T


def loss_fn(params: DenseParams, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["labels"]`` (plus the
    z-loss), the training objective."""
    hidden = forward(params, cfg, batch["tokens"], batch.get("patch_embeds"))
    emb = getattr(params, "unembed", params.embed)
    return chunked_xent(hidden, emb, batch["labels"])


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
