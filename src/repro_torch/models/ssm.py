"""Mamba2 (SSD) blocks and the zamba2-style hybrid stack.

The port's copy of the JAX package's ``models/ssm.py``, serving part.
Prefill uses the chunked *state-space dual* (SSD) form of Mamba2: the
sequence is split into chunks (256, or one chunk when the length is not a
multiple); within a chunk the output is a masked quadratic
(attention-like) contraction, across chunks a short loop carries the
(H, N, P) state.  Decode carries the recurrent state explicitly: O(1) per
token.

zamba2: a stack of Mamba2 blocks with one *shared* GQA attention block
(and MLP) applied after every ``attn_every`` blocks, its parameters shared
across applications.

Same semantics as the JAX package, including a defect of its decode: the
shared block's applications share ONE KV cache (B, wlen, Kv, D), and each
writes its keys at the same position, so the cache keeps only the last
application's keys and every application attends over those at earlier
positions.  Prefill gives every application its own keys, so decode
differs from prefill after position 0.  The port keeps this.

Not here: ``loss_fn`` (training).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from .layers import (
    MLP, Attention, RMSNorm, _chunks, _param, attention_decode, dense_init_,
    mlp, rmsnorm,
)
from .transformer import _attention_dyn, _embed, attn_spec, logits_fn

Cache = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state


class Mamba(nn.Module):
    """``w_in`` (d, 2 d_in + 2 N + H) fused input projection -> [x, z, B,
    C, dt], ``w_out`` (d_in, d), ``conv`` (4, d_in) depthwise causal
    conv, ``A_log`` / ``D`` / ``dt_bias`` (H,) float32, ``norm``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        d_in, nh, ns = mamba_dims(cfg)
        dt = cfg.p_dtype
        self.w_in = _param((d, 2 * d_in + 2 * ns + nh), dt, device)
        self.w_out = _param((d_in, d), dt, device)
        self.conv = _param((4, d_in), dt, device)
        self.A_log = _param((nh,), torch.float32, device)
        self.D = _param((nh,), torch.float32, device)
        self.dt_bias = _param((nh,), torch.float32, device)
        self.norm = RMSNorm(d_in, dt, device)

    def init_(self, gen: torch.Generator) -> None:
        dense_init_(self.w_in, self.w_in.shape[0], gen)
        dense_init_(self.w_out, self.w_out.shape[0], gen)
        # normal * 0.2, as the JAX package draws it
        dense_init_(self.conv, 25, gen)
        self.A_log.zero_()                      # A = -exp(A_log)
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.init_(gen)


def _mamba_proj(p: Mamba, cfg: ArchConfig, x: torch.Tensor):
    d_in, nh, ns = mamba_dims(cfg)
    zxbcdt = x @ p.w_in.to(x.dtype)
    xs, z, B, C, dtv = torch.split(zxbcdt, [d_in, d_in, ns, ns, nh], dim=-1)
    dtv = F.softplus(dtv.float() + p.dt_bias)          # (..., nh)
    return xs, z, B, C, dtv


def _gated_out(p: Mamba, x: torch.Tensor, y: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """(y + D x) normalized and gated by silu(z), (..., H, P) -> (...,
    d_in) in ``x``'s dtype.  The chain runs in float32 and rounds once, as
    XLA's fusion of these elementwise ops does: rounding after each op (as
    eager bfloat16 does) doubles the error against float32 over two
    blocks."""
    y = y.float() + xh.float() * p.D.to(x.dtype).float()[:, None]
    y = y.reshape(*y.shape[:-2], -1)
    return (rmsnorm(p.norm, y) * F.silu(z.float())).to(x.dtype)


def _causal_conv(p: Mamba, xs: torch.Tensor) -> torch.Tensor:
    """Depthwise width-4 causal conv over sequence (B, S, d_in), in
    float32 and rounded once (XLA fuses the products, sum and silu)."""
    w = p.conv.to(xs.dtype).float()          # (4, d_in)
    pad = F.pad(xs, (0, 0, 3, 0)).float()
    out = sum(pad[:, i:i + xs.shape[1], :] * w[i] for i in range(4))
    return F.silu(out).to(xs.dtype)


def _states_entering(states: torch.Tensor, decay: torch.Tensor
                     ) -> torch.Tensor:
    """The inter-chunk scan: h_n = decay_n h_{n-1} + S_n from h_0 = 0,
    in float32.  states (B, nc, H, ...), decay (B, nc, H) -> the state
    *entering* each chunk, (B, nc, H, ...) float32."""
    h = torch.zeros_like(states[:, 0], dtype=torch.float32)
    entering = []
    for n in range(states.shape[1]):
        entering.append(h)
        h = h * decay[:, n, :, None, None] + states[:, n].float()
    return torch.stack(entering, dim=1)


def mamba_forward(p: Mamba, cfg: ArchConfig, x: torch.Tensor,
                  chunk: int = 256) -> torch.Tensor:
    """Chunked SSD forward. x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    d_in, nh, ns = mamba_dims(cfg)
    hp = d_in // nh
    xs, z, B, C, dtv = _mamba_proj(p, cfg, x)
    xs = _causal_conv(p, xs)
    xh = xs.reshape(b, s, nh, hp)
    A = -torch.exp(p.A_log)                                 # (nh,)
    dA = dtv * A                                            # (B, S, nh) <= 0

    c, nc = _chunks(s, chunk)
    xh_c = xh.reshape(b, nc, c, nh, hp)
    B_c = B.reshape(b, nc, c, ns)
    C_c = C.reshape(b, nc, c, ns)
    dA_c = dA.reshape(b, nc, c, nh)
    dt_c = dtv.reshape(b, nc, c, nh)

    # cumulative within-chunk log decay: L[i] = sum_{j<=i} dA
    seg = torch.cumsum(dA_c, dim=2)                         # (B, nc, c, nh)

    # ---- intra-chunk (quadratic) term:
    # Y_intra[i] = sum_{j<=i} C_i.B_j * exp(seg_i - seg_j) * dt_j * x_j
    CB = torch.einsum("bnis,bnjs->bnij", C_c, B_c)           # (B,nc,c,c)
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # (B,nc,c,c,nh)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    # where, not a product with the mask: exp overflows to inf above the
    # diagonal, and inf * 0 is NaN
    gate = torch.where(causal[None, None, :, :, None], torch.exp(decay), 0.0)
    M = (CB[..., None] * gate * dt_c[:, :, None, :, :]).to(x.dtype)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", M, xh_c)

    # ---- chunk states: S_n = sum_j exp(seg_end - seg_j) dt_j B_j x_j^T
    end = seg[:, :, -1:, :]                                 # (B,nc,1,nh)
    w_j = (torch.exp(end - seg) * dt_c).to(x.dtype)         # (B,nc,c,nh)
    states = torch.einsum("bnjh,bnjs,bnjhp->bnhsp", w_j, B_c, xh_c)

    # ---- inter-chunk scan: h_n = exp(sum dA_n) h_{n-1} + S_n
    h_in = _states_entering(states, torch.exp(end[:, :, 0, :])).to(x.dtype)

    # ---- inter-chunk contribution: Y_inter[i] = C_i . (exp(seg_i) h_in)
    y_inter = torch.einsum("bnis,bnhsp,bnih->bnihp",
                           C_c, h_in, torch.exp(seg).to(x.dtype))
    y = (y_intra.float() + y_inter.float()).reshape(b, s, nh, hp)
    return _gated_out(p, x, y, xh, z) @ p.w_out.to(x.dtype)


def mamba_decode(p: Mamba, cfg: ArchConfig, x: torch.Tensor,
                 state: torch.Tensor, conv_state: torch.Tensor):
    """O(1) recurrent step. x: (B, 1, d); state: (B, nh, ns, hp);
    conv_state: (B, 4, d_in) rolling window.  Returns (y, state,
    conv_state), new tensors."""
    b = x.shape[0]
    d_in, nh, ns = mamba_dims(cfg)
    hp = d_in // nh
    xs, z, B, C, dtv = _mamba_proj(p, cfg, x)
    conv_state = torch.cat([conv_state[:, 1:], xs.to(conv_state.dtype)],
                           dim=1)
    xs = F.silu(torch.einsum("bwd,wd->bd", conv_state,
                             p.conv.to(x.dtype)))[:, None]
    xh = xs.reshape(b, nh, hp)
    A = -torch.exp(p.A_log)
    dA = torch.exp(dtv[:, 0] * A)                            # (B, nh)
    upd = torch.einsum("bh,bs,bhp->bhsp", dtv[:, 0].to(x.dtype), B[:, 0], xh)
    state = (state * dA[:, :, None, None].to(state.dtype)
             + upd.to(state.dtype))
    y = torch.einsum("bs,bhsp->bhp", C[:, 0], state.to(x.dtype))
    y = _gated_out(p, x, y[:, None], xh[:, None], z)
    return y @ p.w_out.to(x.dtype), state, conv_state


# --------------------------------------------------------------------------
# zamba2 hybrid stack
# --------------------------------------------------------------------------

class SSMLayer(nn.Module):
    """zamba2-style: the per-layer block is Mamba2 only; the MLP lives in
    the parameter-shared transformer block."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.p_dtype, device)
        self.mamba = Mamba(cfg, device)

    def init_(self, gen: torch.Generator) -> None:
        self.ln1.init_(gen)
        self.mamba.init_(gen)


class SSMParams(nn.Module):
    """The JAX parameter tree as modules: ``embed``, ``layers``, ``ln_f``,
    and with ``attn_every`` the shared block ``shared_attn``,
    ``shared_ln``, ``shared_ln2``, ``shared_mlp``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(SSMLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        if cfg.attn_every:
            self.shared_attn = Attention(attn_spec(cfg), dt, device)
            self.shared_ln = RMSNorm(cfg.d_model, dt, device)
            self.shared_ln2 = RMSNorm(cfg.d_model, dt, device)
            self.shared_mlp = MLP(cfg.d_model, cfg.d_ff, dt, device,
                                  cfg.mlp_variant)


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: Device) -> SSMParams:
    """Random initialisation from ``gen``: the JAX package's distributions,
    not its draws."""
    p = SSMParams(cfg, resolve_device(device))
    dense_init_(p.embed, cfg.vocab, gen)
    for layer in p.layers:
        layer.init_(gen)
    p.ln_f.init_(gen)
    if cfg.attn_every:
        for m in (p.shared_attn, p.shared_ln, p.shared_ln2, p.shared_mlp):
            m.init_(gen)
    return p


def _chunk_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_outer, inner): the shared block is applied once after each of
    ``n_outer`` groups of ``inner`` Mamba blocks; (0, L) without it."""
    every = cfg.attn_every
    L = cfg.n_layers
    if every and every <= L and L % every == 0:
        return L // every, every
    return 0, L


def blocks(params: SSMParams, cfg: ArchConfig,
           tokens: torch.Tensor) -> List[Callable]:
    """The stack over ``tokens``' (B, S) positions, in order, each a
    function of the residual stream (B, S, d): the Mamba2 blocks, with the
    shared attention block (and MLP) after every ``inner`` of them."""
    spec = attn_spec(cfg)
    win = cfg.sliding_window or 0
    n_outer, inner = _chunk_layout(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)

    def mamba_block(lp: SSMLayer):
        return lambda x: x + mamba_forward(lp.mamba, cfg, rmsnorm(lp.ln1, x))

    def shared(x):
        h = rmsnorm(params.shared_ln, x)
        x = x + _attention_dyn(params.shared_attn, spec, h, positions, win)
        return x + mlp(params.shared_mlp, rmsnorm(params.shared_ln2, x))

    out: List[Callable] = []
    for i, lp in enumerate(params.layers):
        out.append(mamba_block(lp))
        if n_outer and (i + 1) % inner == 0:
            out.append(shared)
    return out


def forward(params: SSMParams, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Token ids -> final hidden states (B, S, d)."""
    x = _embed(params, cfg, tokens)
    for block in blocks(params, cfg, tokens):
        x = block(x)
    return rmsnorm(params.ln_f, x)


def hidden(params: SSMParams, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The batch's final hidden states (B, S, d)."""
    return forward(params, cfg, batch["tokens"])


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device: Device = "cuda") -> Cache:
    """``ssm`` (L, B, H, N, P) float32 and ``conv`` (L, B, 4, d_in)
    states, and with the shared block ONE rolling KV cache ``k`` / ``v``
    (B, wlen, Kv, D), wlen the sliding window or ``max_seq``."""
    d_in, nh, ns = mamba_dims(cfg)
    hp = d_in // nh
    dt = dtype or cfg.activation_dtype
    device = resolve_device(device)
    cache = {
        "ssm": torch.zeros((cfg.n_layers, batch, nh, ns, hp),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, 4, d_in), dtype=dt,
                            device=device),
    }
    if _chunk_layout(cfg)[0]:
        wlen = min(max_seq, cfg.sliding_window or max_seq)
        shape = (batch, wlen, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def decode_blocks(params: SSMParams, cfg: ArchConfig, cache: Cache,
                  pos: int) -> List[Callable]:
    """The stack for one decode step at ``pos``, in order, each a function
    of the stream (B, 1, d) that writes its state in ``cache``: a Mamba2
    block its layer's ``ssm`` and ``conv``, every application of the
    shared block the one KV cache at ``min(pos, wlen - 1)``."""
    spec = attn_spec(cfg)
    n_outer, inner = _chunk_layout(cfg)

    def mamba_block(i: int, lp: SSMLayer):
        def run(x):
            y, cache["ssm"][i], cache["conv"][i] = mamba_decode(
                lp.mamba, cfg, rmsnorm(lp.ln1, x), cache["ssm"][i],
                cache["conv"][i])
            return x + y
        return run

    def shared(x):
        h = rmsnorm(params.shared_ln, x)
        wpos = min(pos, cache["k"].shape[1] - 1)   # saturating window
        h, _, _ = attention_decode(params.shared_attn, spec, h, cache["k"],
                                   cache["v"], wpos)
        x = x + h
        return x + mlp(params.shared_mlp, rmsnorm(params.shared_ln2, x))

    out: List[Callable] = []
    for i, lp in enumerate(params.layers):
        out.append(mamba_block(i, lp))
        if n_outer and (i + 1) % inner == 0:
            out.append(shared)
    return out


def decode_step(params: SSMParams, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode: (B, 1) tokens at position ``pos`` -> (B, V)
    logits.  The cache is written in place and returned
    (:func:`decode_blocks`)."""
    x = _embed(params, cfg, tokens)
    for block in decode_blocks(params, cfg, cache, pos):
        x = block(x)
    x = rmsnorm(params.ln_f, x)
    return logits_fn(params, cfg, x[:, 0]), cache
