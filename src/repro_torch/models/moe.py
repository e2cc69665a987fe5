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
port writes only the pairs it keeps into the buffer (``dispatch``,
``_scatter_kept``), which leaves that slot zero: the same buffer with no
duplicate writes.  Every shape is fixed by the call's shapes, as JAX's
scatter's are: a lost pair is written to a spare row that is sliced off,
not selected by a boolean mask, so the dispatch runs on the meta device
(the dry run) and never waits on the card for a count.

The gradient agrees too: JAX's scatter passes no cotangent to an
overwritten update, and the port never writes that pair.

With an active mesh whose ``model`` axis divides the experts, ``moe_ffn``
takes ``_moe_ffn_shardmap``, the reference's expert-parallel ``shard_map``
written as stages between collectives (``parallel/collectives.py``): each
data shard's tokens, 1/M of them a ``model`` peer, are dispatched into a
local capacity buffer (no drop at small token counts; otherwise the
``capacity_factor`` knob sets the capacity), exchanged with the experts'
owners, and combined back.  Its dispatch has the same slot ``C - 1``
clobber, so it reuses ``dispatch``.  Under the ``seq_shard_mlp`` knob
the residual stream between the MoE blocks is a grid of sequence blocks
(``forward``, ``_moe_block_stages``).
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
from ..parallel import collectives as coll
from ..parallel import ctx
from .layers import (
    MLP, Attention, RMSNorm, _param, attention_decode, chunked_xent,
    dense_init_, mlp, rmsnorm,
)
from .transformer import (
    Cache, Layer, _attention_dyn, _embed, attention_stages, attn_spec,
    logits_fn, mlp_cols, seq_spec,
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
    logits = xf.float() @ p.router.to(xf.device, torch.float32)
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
    load = torch.zeros(n_experts, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones(n, dtype=torch.int64, device=dev))
    kept = (rank < cap) & ~((rank == cap - 1) & (load > cap)[se])
    return order, se, rank, kept


def _scatter_kept(rows: torch.Tensor, se: torch.Tensor, rank: torch.Tensor,
                  kept: torch.Tensor, n_experts: int, cap: int
                  ) -> torch.Tensor:
    """The (E, C, d) capacity buffer holding each kept pair's row of
    ``rows`` (P, d) at (expert, rank), zeros elsewhere.  Every pair is
    written: a lost one to a spare row past the buffer, which is sliced
    off (its gradient is zero there)."""
    d = rows.shape[-1]
    slot = torch.where(kept, se * cap + rank, n_experts * cap)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=rows.dtype,
                      device=rows.device)
    buf.index_put_((slot,), rows)
    return buf[:n_experts * cap].view(n_experts, cap, d)


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
    """x: (B, S, d) -> (out, aux_loss).

    With an active mesh that has a ``model`` axis dividing the experts,
    the expert-parallel ``_moe_ffn_shardmap``; otherwise the single-device
    dispatch (``_moe_ffn_local``).  With ``routes``, appends this call's
    :class:`Route`s (one a shard on the mesh path)."""
    mesh = ctx.current_mesh()
    if _expert_parallel(cfg, mesh):
        return _moe_ffn_shardmap(p, cfg, x, mesh, routes)
    return _moe_ffn_local(p, cfg, x, routes)


def _expert_parallel(cfg: ArchConfig, mesh) -> bool:
    """Whether ``moe_ffn`` takes the expert-parallel route on ``mesh``."""
    return (mesh is not None and "model" in mesh.axis_names
            and cfg.n_experts % mesh.shape["model"] == 0)


def _moe_ffn_local(p: MoEFFN, cfg: ArchConfig, x: torch.Tensor,
                   routes: Optional[list] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's single-device dispatch: capacity ``capacity(cfg,
    B * S)``, every expert on ``x``'s device."""
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
    gathered = ctx.constrain(xf[tok], (ctx.DP, None))
    buf = _scatter_kept(gathered, se, rank, kept, e, cap)
    # EP x DP: experts over `model`, capacity slots over the data axes
    buf = ctx.constrain(buf, ("model", ctx.DP, None))

    # ---- expert SwiGLU over all E experts at capacity C
    out_buf = ctx.constrain(_experts(p, buf, slice(None)),
                            ("model", ctx.DP, None))

    # ---- return + combine (summed in the activation dtype, as JAX's
    # scatter-add)
    vals = out_buf[se, torch.clamp(rank, max=cap - 1)] * kept[:, None].to(dt)
    vals = ctx.constrain(vals, (ctx.DP, None))
    contrib = torch.zeros((t, d), dtype=dt, device=dev).index_add_(
        0, tok, vals * topv.reshape(-1)[order, None].to(dt))
    contrib = ctx.constrain(contrib, (ctx.DP, None))
    if hasattr(p, "shared"):
        contrib = contrib + mlp(p.shared, xf)
    return contrib.reshape(b, s, d), aux


def _experts(p: MoEFFN, buf: torch.Tensor, experts: slice) -> torch.Tensor:
    """SwiGLU of the ``experts`` slice over their capacity slots: buf (E',
    C, d) -> (E', C, d), in ``buf``'s dtype and on its device."""
    dt, dev = buf.dtype, buf.device
    gate = F.silu(torch.einsum("ecd,edf->ecf", buf,
                               p.w_gate[experts].to(dev, dt)))
    up = torch.einsum("ecd,edf->ecf", buf, p.w_up[experts].to(dev, dt))
    return torch.einsum("ecf,efd->ecd", gate * up,
                        p.w_down[experts].to(dev, dt))


def _moe_ffn_shardmap(p: MoEFFN, cfg: ArchConfig, x: torch.Tensor, mesh,
                      routes: Optional[list] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-pattern expert parallelism: the reference's ``shard_map``.
    ``x`` (B, S, d) is split over the data axes (``B / dp`` rows a shard)
    and replicated over ``model``, the shard's tokens go through
    ``_moe_stages``, and the output is the data shards' rows (model peer
    0's) on ``x``'s device, plus the shared experts, run whole."""
    b, s, d = x.shape
    dp = ctx.dp_axes(mesh)
    dp_sz = math.prod(mesh.shape[a] for a in dp)
    if b % dp_sz:
        raise ValueError(f"batch {b} does not split over the data axes "
                         f"{dp} ({dp_sz} shards)")
    b_l = b // dp_sz
    rows = {c: x[coll.index_along(mesh, c, dp) * b_l:][:b_l].to(
        coll.device_of(mesh, c)) for c in coll.coords(mesh)}
    contrib, aux = _moe_stages(p, cfg, rows, mesh, routes)
    lead = _lead(mesh)
    out = torch.cat([contrib[c].to(x.device) for c in lead], dim=0)
    if hasattr(p, "shared"):
        out = out + mlp(p.shared, x.reshape(b * s, d)).reshape(b, s, d)
    return out, aux[lead[0]].to(x.device)


def _lead(mesh) -> List[coll.Coord]:
    """The coordinates of ``model`` peer 0, one a data shard in order."""
    return [c for c in coll.coords(mesh)
            if coll.index_along(mesh, c, "model") == 0]


def _moe_stages(p: MoEFFN, cfg: ArchConfig, rows: coll.Grid, mesh,
                routes: Optional[list] = None
                ) -> Tuple[coll.Grid, coll.Grid]:
    """The body of the reference's ``shard_map`` as three stages between
    collectives, on a grid of each coordinate's data rows (B/dp, S, d),
    replicated over ``model``.  Returns the routed experts' output (a grid
    of the same rows, replicated over ``model``) and the aux loss (a grid).

    Experts are split over ``model`` (E/M a peer).  When the shard's
    ``t_l`` tokens split evenly over the M peers, each peer routes its own
    1/M slice (``t_loc`` tokens); otherwise every peer routes all of them.
    Capacity is ``t_loc * k`` (nothing drops) while that is at most 512,
    else ``ceil(t_loc * k / E * cf)`` rounded up to a multiple of 8 (at
    least 8), ``cf`` the ``capacity_factor`` knob or the config's.

    1. dispatch (per coordinate): route, aux, the sort-dispatch into an
       (E, C, d) buffer, viewed as (M, E/M, C, d);
       ``pmean`` of aux over the data axes (and ``model`` when sliced),
       ``all_to_all`` over ``model`` to the experts' owners;
    2. experts (per coordinate): SwiGLU of the peer's E/M experts over the
       M * C slots it received; the reverse ``all_to_all``;
    3. combine (per coordinate): gather the pairs' outputs back, weight and
       add them per token; ``all_gather`` over ``model`` when sliced.

    With ``routes``, appends one :class:`Route` for each coordinate that
    routes its own tokens (every peer when sliced, else model peer 0), in
    token order."""
    b_l, s, d = next(iter(rows.values())).shape
    e, k = cfg.n_experts, cfg.experts_per_token
    m_sz = mesh.shape["model"]
    e_l = e // m_sz
    dp = ctx.dp_axes(mesh)
    t_l = b_l * s
    slice_tokens = t_l % m_sz == 0 and t_l >= m_sz
    t_loc = t_l // m_sz if slice_tokens else t_l
    cf = tuning.get("capacity_factor") or cfg.capacity_factor
    if t_loc * k <= 512:
        cap = t_loc * k                     # decode: no-drop tiny buffer
    else:
        cap = int(math.ceil(t_loc * k / e * cf))
        cap = max(8, -(-cap // 8) * 8)
    dt = next(iter(rows.values())).dtype

    def dispatch_stage(c, dev, x):
        xf = x.reshape(t_l, d)
        if slice_tokens:
            m = coll.index_along(mesh, c, "model")
            xf = xf[m * t_loc:(m + 1) * t_loc]
        probs, topv, topi = route(p, cfg, xf)
        me = probs.mean(dim=0)
        ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
            0, topi.reshape(-1), torch.ones(t_loc * k, device=dev)) / (t_loc * k)
        aux = e * torch.sum(me * ce)
        order, se, rank, kept = dispatch(topi, cap, e)
        tok = (torch.arange(t_loc * k, device=dev) // k)[order]
        buf = _scatter_kept(xf[tok], se, rank, kept, e, cap)
        return aux, buf.reshape(m_sz, e_l, cap, d), (probs, topv, topi,
                                                     order, se, rank, kept, tok)

    aux, buf, state = coll.run(mesh, dispatch_stage, rows)
    aux_axes = dp + (("model",) if slice_tokens else ())
    if aux_axes:
        aux = coll.pmean(mesh, aux, aux_axes)
    buf = coll.all_to_all(mesh, buf, "model")        # block j -> peer j

    def expert_stage(c, dev, buf):
        m = coll.index_along(mesh, c, "model")
        buf = buf.transpose(0, 1).reshape(e_l, m_sz * cap, d)
        out = _experts(p, buf, slice(m * e_l, (m + 1) * e_l))
        return out.reshape(e_l, m_sz, cap, d).transpose(0, 1)

    out_buf = coll.all_to_all(mesh, coll.run(mesh, expert_stage, buf),
                              "model")

    def combine_stage(c, dev, out_buf, st):
        _, topv, _, order, se, rank, kept, tok = st
        out_buf = out_buf.reshape(e, cap, d)
        vals = out_buf[se, torch.clamp(rank, max=cap - 1)] \
            * kept[:, None].to(dt)
        return torch.zeros((t_loc, d), dtype=dt, device=dev).index_add_(
            0, tok, vals * topv.reshape(-1)[order, None].to(dt))

    contrib = coll.run(mesh, combine_stage, out_buf, state)
    if slice_tokens:  # rebuild the full data-row (replicated over model)
        contrib = coll.all_gather(mesh, contrib, "model", dim=0)
    if routes is not None:
        lead = _lead(mesh)
        for c in coll.coords(mesh):
            if slice_tokens or c in lead:
                probs, _, topi, order, se, _, kept, _ = state[c]
                routes.append(Route(probs, topi, _unsort(
                    order, torch.where(kept, se, -1)).reshape(topi.shape)))
    return coll.run(mesh, lambda c, dev, y: y.reshape(b_l, s, d),
                    contrib), aux


def _moe_block_stages(cfg: ArchConfig, mesh, grid: coll.Grid,
                      layer_p: "MoELayer", positions,
                      routes: Optional[list] = None
                      ) -> Tuple[coll.Grid, torch.Tensor]:
    """A MoE block on a grid of sequence blocks (B/dp, S/M, d), under the
    ``seq_shard_mlp`` knob: the dense attention half
    (``transformer.attention_stages``), then norm, all-gather over
    ``model`` to the ``_moe_stages`` layout (the reference's ``shard_map``
    in-spec), its stages, each coordinate's S/M rows of their output (a
    slice: the output is replicated over ``model``) plus the shared
    experts on those rows, and the residual add.  Returns (grid, aux)."""
    p = layer_p.moe
    grid = attention_stages(cfg, mesh, grid, layer_p.ln1, layer_p.attn,
                            positions, 0)
    h = coll.run(mesh, lambda c, dev, x: rmsnorm(layer_p.ln2, x), grid)
    contrib, aux = _moe_stages(p, cfg,
                               coll.all_gather(mesh, h, "model", dim=1),
                               mesh, routes)

    def add(c, dev, x, h, y):
        n = x.shape[1]
        y = y.narrow(1, coll.index_along(mesh, c, "model") * n, n)
        if hasattr(p, "shared"):
            y = y + mlp_cols(p.shared, h, 0, p.shared.w_up.shape[1])
        return x + y

    return coll.run(mesh, add, grid, h, contrib), aux[_lead(mesh)[0]]


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
    recomputation appends to a list of its own).  Where the MoE takes the
    expert-parallel route and ``transformer.seq_spec`` splits the stream,
    the stream is cut into sequence blocks where the reference first
    constrains it, after the first MoE block; the blocks after it run as
    ``_moe_block_stages``, and the blocks are joined before ``ln_f``."""
    x = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    mesh = ctx.current_mesh()
    spec = seq_spec(x.shape) if _expert_parallel(cfg, mesh) else None
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    fresh = None if routes is None else []

    def staged(grid, layer_p):
        return _moe_block_stages(cfg, mesh, grid, layer_p, positions, fresh)

    grid = None
    for layer_p, block in zip(_layers(params),
                              blocks(params, cfg, tokens, fresh)):
        if grid is None:
            x, a = tuning.remat_wrap(block)(x)
            if spec is not None and isinstance(layer_p, MoELayer):
                grid = ctx.shard(x, spec)
        else:
            grid, a = tuning.remat_wrap(staged)(grid, layer_p)
        aux = aux + a.to(aux.device)
        if fresh:
            routes.extend(fresh)
            fresh.clear()
    if grid is not None:
        x = ctx.unshard(grid, spec)
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
