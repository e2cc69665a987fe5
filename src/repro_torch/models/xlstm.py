"""xLSTM stack (sLSTM + mLSTM blocks) — xlstm-350m.

The port's copy of the JAX package's ``models/xlstm.py``, serving part.

* mLSTM: matrix-memory cell in its parallel *chunked* form — a gated
  linear-attention contraction with per-step scalar forget decay (the
  two-level chunk structure of the Mamba2 SSD path: quadratic intra-chunk,
  an inter-chunk loop over the (H, dk, dv) state).  Head size 2d / H.
* sLSTM: scalar-memory cell with true hidden-to-gate recurrence — serial
  by construction, a Python loop over time here (JAX scans it).  Head
  size d / H.

Block pattern: every ``slstm_every``-th block is an sLSTM, the rest are
mLSTM, grouped into rounds of ``m_per`` mLSTM blocks and one sLSTM.
Blocks are pre-LN residual with internal up/down projections; no separate
FFN.  Parameters: ``mlstm`` is a list of rounds, each a list of blocks
(the JAX tree stacks them on two axes), ``slstm`` one block a round.

Not here: ``loss_fn`` (training).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from .layers import RMSNorm, _chunks, _param, dense_init_, rmsnorm
from .ssm import _states_entering
from .transformer import _embed, logits_fn

Cache = Dict[str, torch.Tensor]


def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_up = 2 * cfg.d_model
    nh = cfg.n_heads
    hd = d_up // nh
    return d_up, nh, hd


# --------------------------------------------------------------- mLSTM

class MLSTM(nn.Module):
    """``ln``, ``w_up`` (d, 2 d_up) value path and output gate, ``wq`` /
    ``wk`` (d, d_up), ``w_if`` (d, 2 H) input and forget gates,
    ``w_down`` (d_up, d), ``norm``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        d_up, nh, _ = _dims(cfg)
        dt = cfg.p_dtype
        self.ln = RMSNorm(d, dt, device)
        self.w_up = _param((d, 2 * d_up), dt, device)
        self.wq = _param((d, d_up), dt, device)
        self.wk = _param((d, d_up), dt, device)
        self.w_if = _param((d, 2 * nh), dt, device)
        self.w_down = _param((d_up, d), dt, device)
        self.norm = RMSNorm(d_up, dt, device)

    def init_(self, gen: torch.Generator) -> None:
        self.ln.init_(gen)
        for w in (self.w_up, self.wq, self.wk, self.w_if, self.w_down):
            dense_init_(w, w.shape[0], gen)
        self.norm.init_(gen)


def _mlstm_in(p: MLSTM, cfg: ArchConfig, x: torch.Tensor):
    """The block's projections: q, k (scaled by 1/sqrt(hd)), v, the output
    gate, and the float32 input and forget gate pre-activations."""
    d_up, nh, hd = _dims(cfg)
    lead = x.shape[:-1]
    h = rmsnorm(p.ln, x)
    v, og = torch.chunk(h @ p.w_up.to(x.dtype), 2, dim=-1)
    q = (h @ p.wq.to(x.dtype)).reshape(*lead, nh, hd)
    k = (h @ p.wk.to(x.dtype)).reshape(*lead, nh, hd) / math.sqrt(hd)
    v = v.reshape(*lead, nh, hd)
    ig, fg = torch.chunk((h @ p.w_if.to(x.dtype)).float(), 2, dim=-1)
    return q, k, v, og, ig, fg


def _mlstm_out(p: MLSTM, cfg: ArchConfig, x, y, og) -> torch.Tensor:
    """x + (norm(y) * silu(og)) W_down.  The gate runs in float32 and
    rounds once before the product, as XLA's fusion of these elementwise
    ops does (rounding after each, as eager bfloat16 does, doubles the
    error against float32 over the 24 blocks of xlstm-350m)."""
    y = (rmsnorm(p.norm, y.float()) * F.silu(og.float())).to(x.dtype)
    return x + y @ p.w_down.to(x.dtype)


def mlstm_forward(p: MLSTM, cfg: ArchConfig, x: torch.Tensor,
                  chunk: int = 256) -> torch.Tensor:
    b, s, d = x.shape
    d_up, nh, hd = _dims(cfg)
    q, k, v, og, ig, fg = _mlstm_in(p, cfg, x)
    logf = F.logsigmoid(fg)
    i_gate = torch.exp(torch.clamp(ig, max=0.0))          # stabilized

    c, nc = _chunks(s, chunk)
    qc = q.reshape(b, nc, c, nh, hd)
    kc = k.reshape(b, nc, c, nh, hd)
    vc = v.reshape(b, nc, c, nh, hd)
    ic = i_gate.reshape(b, nc, c, nh)
    Fc = torch.cumsum(logf.reshape(b, nc, c, nh), dim=2)  # cum log decay

    # intra-chunk: D_ij = exp(F_i - F_j) * i_j, causal; where, not a
    # product with the mask (inf * 0 is NaN)
    delta = Fc[:, :, :, None, :] - Fc[:, :, None, :, :]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    D = torch.where(causal[None, None, :, :, None], torch.exp(delta), 0.0)
    D = D * ic[:, :, None, :, :]                           # (B,nc,i,j,nh)
    scores = torch.einsum("bnihd,bnjhd->bnijh", qc, kc)
    M = scores.float() * D
    y_intra = torch.einsum("bnijh,bnjhd->bnihd", M.to(x.dtype), vc)

    # inter-chunk state: S_n = sum_j exp(F_end - F_j) i_j k_j v_j^T
    end = Fc[:, :, -1:, :]
    wj = (torch.exp(end - Fc) * ic).to(x.dtype)
    states = torch.einsum("bnjh,bnjhd,bnjhe->bnhde", wj, kc, vc)
    h_in = _states_entering(states, torch.exp(end[:, :, 0, :])).to(x.dtype)

    y_inter = torch.einsum("bnihd,bnhde->bnihe",
                           qc * torch.exp(Fc).to(x.dtype)[..., None], h_in)
    y = (y_intra.float() + y_inter.float()).reshape(b, s, d_up)
    return _mlstm_out(p, cfg, x, y, og)


def mlstm_decode(p: MLSTM, cfg: ArchConfig, x: torch.Tensor,
                 state: torch.Tensor):
    """x: (B, 1, d); state: (B, nh, hd, hd) fp32.  Returns (out, state),
    new tensors."""
    b = x.shape[0]
    d_up, nh, hd = _dims(cfg)
    q, k, v, og, ig, fg = _mlstm_in(p, cfg, x)
    q, k, v, ig, fg = q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]
    f = torch.exp(F.logsigmoid(fg))
    i = torch.exp(torch.clamp(ig, max=0.0))
    state = state * f[:, :, None, None] + (
        i[:, :, None, None]
        * torch.einsum("bhd,bhe->bhde", k, v).float())
    y = torch.einsum("bhd,bhde->bhe", q.float(), state).to(x.dtype)
    return _mlstm_out(p, cfg, x, y.reshape(b, 1, d_up), og), state


# --------------------------------------------------------------- sLSTM

class SLSTM(nn.Module):
    """``ln``, ``w_x`` (d, 4d) i, f, z, o from the input, ``w_h``
    (H, d/H, 4 d/H) block-diagonal recurrence, ``w_down`` (d, d)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        hd = d // nh
        dt = cfg.p_dtype
        self.ln = RMSNorm(d, dt, device)
        self.w_x = _param((d, 4 * d), dt, device)
        self.w_h = _param((nh, hd, 4 * hd), dt, device)
        self.w_down = _param((d, d), dt, device)

    def init_(self, gen: torch.Generator) -> None:
        self.ln.init_(gen)
        dense_init_(self.w_x, self.w_x.shape[0], gen)
        dense_init_(self.w_h, self.w_h.shape[1], gen)
        dense_init_(self.w_down, self.w_down.shape[0], gen)


def _slstm_cell(p: SLSTM, cfg: ArchConfig, xt, hprev, cprev):
    """xt: (B, 4d) pre-projected input; hprev/cprev: (B, nh, hd) fp32."""
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    rec = torch.einsum("bhd,hde->bhe", hprev.to(xt.dtype), p.w_h.to(xt.dtype))
    # the sum in float32, as XLA fuses it into the cast
    gates = xt.reshape(xt.shape[0], nh, 4 * hd).float() + rec.float()
    i, f, z, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * cprev + torch.exp(torch.clamp(i, max=0.0)) \
        * torch.tanh(z)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def slstm_forward(p: SLSTM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    nh = cfg.n_heads
    xproj = rmsnorm(p.ln, x) @ p.w_x.to(x.dtype)             # (B, S, 4d)
    h = c = torch.zeros((b, nh, d // nh), dtype=torch.float32,
                        device=x.device)
    hs = []
    for t in range(s):
        h, c = _slstm_cell(p, cfg, xproj[:, t], h, c)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return x + y @ p.w_down.to(x.dtype)


def slstm_decode(p: SLSTM, cfg: ArchConfig, x: torch.Tensor, h, c):
    """x: (B, 1, d); h, c: (B, nh, hd) fp32.  Returns (out, h, c), new
    tensors."""
    xproj = (rmsnorm(p.ln, x) @ p.w_x.to(x.dtype))[:, 0]
    h, c = _slstm_cell(p, cfg, xproj, h, c)
    y = h.reshape(x.shape[0], 1, cfg.d_model).to(x.dtype)
    return x + y @ p.w_down.to(x.dtype), h, c


# --------------------------------------------------------------- stack

def rounds_of(cfg: ArchConfig) -> Tuple[int, int]:
    """(rounds, mLSTM blocks a round); one round of all L blocks when
    there is no sLSTM."""
    every = cfg.slstm_every or cfg.n_layers + 1
    if every > cfg.n_layers:
        return 1, cfg.n_layers
    return cfg.n_layers // every, every - 1


def _has_slstm(cfg: ArchConfig) -> bool:
    return bool(cfg.slstm_every) and cfg.slstm_every <= cfg.n_layers


class XLSTMParams(nn.Module):
    """The JAX parameter tree as modules: ``embed``, ``ln_f``, ``mlstm``
    (rounds x blocks) and ``slstm`` (one a round)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.p_dtype
        n_rounds, m_per = rounds_of(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.ln_f = RMSNorm(cfg.d_model, dt, device)
        self.mlstm = nn.ModuleList(
            nn.ModuleList(MLSTM(cfg, device) for _ in range(m_per))
            for _ in range(n_rounds))
        if _has_slstm(cfg):
            self.slstm = nn.ModuleList(SLSTM(cfg, device)
                                       for _ in range(n_rounds))


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: Device) -> XLSTMParams:
    """Random initialisation from ``gen``: the JAX package's distributions,
    not its draws."""
    p = XLSTMParams(cfg, resolve_device(device))
    dense_init_(p.embed, cfg.vocab, gen)
    p.ln_f.init_(gen)
    for ms in p.mlstm:
        for m in ms:
            m.init_(gen)
    for s in getattr(p, "slstm", ()):
        s.init_(gen)
    return p


def blocks(params: XLSTMParams, cfg: ArchConfig,
           tokens: torch.Tensor) -> List[Callable]:
    """The stack in order, each a function of the residual stream
    (B, S, d): every round's mLSTM blocks, then its sLSTM block (the
    blocks carry position in their recurrence; ``tokens`` only shares
    the other families' signature)."""
    out: List[Callable] = []
    for r, ms in enumerate(params.mlstm):
        out += [functools.partial(mlstm_forward, mp, cfg) for mp in ms]
        if hasattr(params, "slstm"):
            out.append(functools.partial(slstm_forward, params.slstm[r], cfg))
    return out


def forward(params: XLSTMParams, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Token ids -> final hidden states (B, S, d)."""
    x = _embed(params, cfg, tokens)
    for block in blocks(params, cfg, tokens):
        x = block(x)
    return rmsnorm(params.ln_f, x)


def hidden(params: XLSTMParams, cfg: ArchConfig,
           batch: dict) -> torch.Tensor:
    """The batch's final hidden states (B, S, d)."""
    return forward(params, cfg, batch["tokens"])


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device: Device = "cuda") -> Cache:
    """``m_state`` (rounds, m_per, B, H, 2d/H, 2d/H) and, with sLSTM,
    ``s_h`` / ``s_c`` (rounds, B, H, d/H), all float32 (``dtype`` and
    ``max_seq`` do not size a recurrent state)."""
    n_rounds, m_per = rounds_of(cfg)
    _, nh, hd = _dims(cfg)
    device = resolve_device(device)
    cache = {"m_state": torch.zeros((n_rounds, m_per, batch, nh, hd, hd),
                                    dtype=torch.float32, device=device)}
    if _has_slstm(cfg):
        shape = (n_rounds, batch, nh, cfg.d_model // nh)
        cache["s_h"] = torch.zeros(shape, dtype=torch.float32, device=device)
        cache["s_c"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return cache


def decode_blocks(params: XLSTMParams, cfg: ArchConfig, cache: Cache,
                  pos: int) -> List[Callable]:
    """The stack for one decode step, in order, each a function of the
    stream (B, 1, d) that writes its recurrent state in ``cache`` (``pos``
    is unused: the states carry the position)."""
    def m_block(r: int, m: int, mp: MLSTM):
        def run(x):
            x, cache["m_state"][r, m] = mlstm_decode(mp, cfg, x,
                                                     cache["m_state"][r, m])
            return x
        return run

    def s_block(r: int):
        def run(x):
            x, cache["s_h"][r], cache["s_c"][r] = slstm_decode(
                params.slstm[r], cfg, x, cache["s_h"][r], cache["s_c"][r])
            return x
        return run

    out: List[Callable] = []
    for r, ms in enumerate(params.mlstm):
        out += [m_block(r, m, mp) for m, mp in enumerate(ms)]
        if "s_h" in cache:
            out.append(s_block(r))
    return out


def decode_step(params: XLSTMParams, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode; the recurrent states are written in place
    (:func:`decode_blocks`)."""
    x = _embed(params, cfg, tokens)
    for block in decode_blocks(params, cfg, cache, pos):
        x = block(x)
    x = rmsnorm(params.ln_f, x)
    return logits_fn(params, cfg, x[:, 0]), cache
