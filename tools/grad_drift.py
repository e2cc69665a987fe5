"""How far an LM's bfloat16 gradients drift from its float32 gradients, in
the JAX package and in the PyTorch port, on the CPU: end to end and block
by block.

    PYTHONPATH=src python tools/grad_drift.py ARCH DEPTH [--width-div N]
        [--batch B] [--seq S] [--rounding fused|every-op] [--seed S]
        [--hold MARGIN]

ARCH is cut as ``tools/lm_drift.py`` cuts it (DEPTH blocks, a 4096-token
vocabulary and, with ``--width-div N``, its widths divided by N), with the
JAX package's ``init(PRNGKey(S))`` weights carried to the port through
``params_from_jax``, and a batch of B x S seeded tokens and labels (and
frames for the encoder-decoder family).  One JSON line:

* end to end: the gradient of ``Model.loss`` with respect to every
  parameter, bfloat16 against float32, in each package: per leaf the
  cosine and the relative L2 error, their worst and mean over the leaves,
  and the global norm's relative gap; and the packages' float32 gradients
  against each other;
* block by block (the moe, ssm_hybrid and xlstm families): each block is
  fed the port's float32 stream input to it and the float32 backward's
  cotangent of its output (a MoE block's aux loss its weight in the loss),
  as ``chip_smoke.py`` phase 16d feeds the port's blocks on the card, and
  its bfloat16 vector-Jacobian product is compared with its float32 one in
  each package: per block the smallest parameter-gradient cosine and the
  input cotangent's relative L2 error, and their worst over the blocks.

``--rounding`` sets how XLA rounds the JAX package's bfloat16, as in
``tools/lm_drift.py``.  With ``--hold MARGIN`` the exit code is 1 if the
port's mean leaf error end to end, or its worst block (1 - cosine, or
input cotangent error), exceeds MARGIN times JAX's.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lm_drift import ROUNDING, VOCAB, cut  # noqa: E402

AUX_WEIGHT = 0.01                  # moe.loss_fn's weight of the aux loss


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def leaves(tree) -> dict:
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def leaf_drift(g16: dict, g32: dict) -> dict:
    """bf16 against float32 gradients, leaf by leaf (leaves whose float32
    gradient is all zero, parameters that do not reach the loss at this
    depth, are counted apart)."""
    used = [k for k in g32 if np.any(g32[k])]
    cos = {k: cosine(g16[k], g32[k]) for k in used}
    err = [rel_err(g16[k], g32[k]) for k in used]
    n16 = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                      for v in g16.values()))
    n32 = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                      for v in g32.values()))
    worst = min(cos, key=cos.get)
    return {"min_cosine": cos[worst], "min_cosine_leaf": worst,
            "mean_cosine": float(np.mean(list(cos.values()))),
            "leaves_below_0.99": sum(c < 0.99 for c in cos.values()),
            "mean_leaf_err": float(np.mean(err)), "max_leaf_err": max(err),
            "grad_norm_gap": abs(n16 - n32) / n32, "leaves": len(cos),
            "leaves_zero": len(g32) - len(used)}


def end_to_end(jcfg, jparams, cfg, params, batch) -> dict:
    """{(package, dtype): gradient leaves keyed by JAX tree paths}."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models.model import build_model as jax_build_model
    from repro_torch.models.convert import named_to_numpy
    from repro_torch.models.model import build_model
    from repro_torch.train.step import value_and_grad

    out = {}
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                              else v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for dtype in ("float32", "bfloat16"):
        m = jax_build_model(dataclasses.replace(jcfg, dtype=dtype))
        _, g = jax.jit(jax.value_and_grad(m.loss))(jparams, jb)
        out["jax", dtype] = leaves(g)
        model = build_model(dataclasses.replace(cfg, dtype=dtype),
                            device="cpu")
        _, g = value_and_grad(model, params, tb)
        out["port", dtype] = leaves(named_to_numpy(g.items()))
    return out


def jax_block_fns(jcfg, jparams, tokens):
    """The JAX package's blocks in the port's ``Model.blocks`` order:
    [(kind, params slice)], and {kind: fn(params, x) -> (y, aux)}, the
    bodies of the JAX package's ``forward`` scans."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jm
    from repro.models import ssm as js
    from repro.models import xlstm as jx
    from repro.models.layers import mlp, rmsnorm
    from repro.models.transformer import _attention_dyn, attn_spec

    b, s = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    spec = attn_spec(jcfg)
    zero = jnp.float32(0.0)

    def at(tree, *idx):
        return jax.tree_util.tree_map(lambda a: a[idx], tree)

    def attn_mlp(p, x, win):
        x = x + _attention_dyn(p["attn"], spec, rmsnorm(p["ln1"], x),
                               positions, win, 512)
        return x + mlp(p["mlp"], rmsnorm(p["ln2"], x))

    def moe_block(p, x):
        x = x + _attention_dyn(p["attn"], spec, rmsnorm(p["ln1"], x),
                               positions, jnp.int32(0), 512)
        h, a = jm.moe_ffn(p["moe"], jcfg, rmsnorm(p["ln2"], x))
        return x + h, a

    def shared(p, x):
        h = rmsnorm(p["shared_ln"], x)
        x = x + _attention_dyn(p["shared_attn"], spec, h, positions,
                               jnp.int32(jcfg.sliding_window or 0), 512)
        return x + mlp(p["shared_mlp"], rmsnorm(p["shared_ln2"], x)), zero

    fns = {
        "mlstm": lambda p, x: (jx.mlstm_forward(p, jcfg, x), zero),
        "slstm": lambda p, x: (jx.slstm_forward(p, jcfg, x), zero),
        "mamba": lambda p, x: (x + js.mamba_forward(
            p["mamba"], jcfg, rmsnorm(p["ln1"], x)), zero),
        "shared": shared,
        "dense": lambda p, x: (attn_mlp(p, x, jnp.int32(0)), zero),
        "moe": moe_block,
    }
    order = []
    if jcfg.family == "xlstm":
        rounds, m_per = jparams["mlstm"]["wq"].shape[:2]
        for r in range(rounds):
            order += [("mlstm", at(jparams["mlstm"], r, j))
                      for j in range(m_per)]
            if "slstm" in jparams:
                order.append(("slstm", at(jparams["slstm"], r)))
    elif jcfg.family == "ssm_hybrid":
        n_outer, inner = js._chunk_layout(jcfg)
        sp = {k: jparams[k] for k in ("shared_ln", "shared_attn",
                                      "shared_mlp", "shared_ln2")}
        for i in range(jcfg.n_layers):
            order.append(("mamba", at(jparams["layers"], i)))
            if n_outer and (i + 1) % inner == 0:
                order.append(("shared", sp))
    else:
        for name, kind in (("dense_layers", "dense"), ("moe_layers", "moe")):
            if name in jparams:
                n = jax.tree_util.tree_leaves(jparams[name])[0].shape[0]
                order += [(kind, at(jparams[name], i)) for i in range(n)]
    return order, fns


def block_by_block(jcfg, jparams, cfg, params, data) -> dict:
    """Per block and package: the smallest parameter-gradient cosine and
    the input cotangent's error, bfloat16 against float32, every block fed
    the port's float32 stream and cotangent."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.models import transformer
    from repro_torch.models.layers import chunked_xent, rmsnorm
    from repro_torch.models.model import build_model

    m16 = build_model(dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"), "cpu")
    tokens = data["tokens"]
    tok = torch.from_numpy(tokens.astype(np.int64))
    aux_ct = AUX_WEIGHT / max(1, cfg.n_layers) if cfg.family == "moe" \
        else None
    named = list(params.named_parameters())
    ps = [p for _, p in named]
    order, fns = jax_block_fns(jcfg, jparams, jnp.asarray(tokens))

    @functools.partial(jax.jit, static_argnums=0)
    def jax_vjp(kind, p, x, ct, act):
        _, f = jax.vjp(fns[kind], p, x)
        return f((ct, act))

    def port_vjp(y, x_in, ct):
        ys, cts = ([y[0]], [ct]) if aux_ct else ([y], [ct])
        if aux_ct and y[1].requires_grad:
            ys.append(y[1])
            cts.append(torch.full_like(y[1], aux_ct))
        return torch.autograd.grad(ys, [x_in] + ps, cts, allow_unused=True)

    for p in ps:
        p.requires_grad_(True)
    rows = []
    with torch.enable_grad():
        x = transformer._embed(params, m32.cfg, tok).detach()
        ins, outs = [], []
        for blk in m32.blocks(params, tok):
            ins.append(x.requires_grad_(True))
            outs.append(blk(x))
            x = (outs[-1][0] if aux_ct else outs[-1]).detach()
        assert len(ins) == len(order), (len(ins), len(order))
        x.requires_grad_(True)
        dy = torch.autograd.grad(chunked_xent(
            rmsnorm(params.ln_f, x), params.embed,
            torch.from_numpy(data["labels"].astype(np.int64))), x)[0]
        b16 = m16.blocks(params, tok)
        for i in reversed(range(len(ins))):
            g32 = port_vjp(outs[i], ins[i], dy)
            outs[i] = None
            x16 = ins[i].detach().to(torch.bfloat16).requires_grad_(True)
            g16 = port_vjp(b16[i](x16), x16, dy.to(torch.bfloat16))
            kind, jp = order[i]
            row = {"block": i, "kind": kind}
            got = {}
            for dt, tdt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
                jd = jnp.dtype(dt)
                gp, gx = jax_vjp(
                    kind, jp, jnp.asarray(ins[i].detach().to(tdt).float()
                                          .numpy(), jd),
                    jnp.asarray(dy.to(tdt).float().numpy(), jd),
                    jnp.float32(aux_ct or 0.0))
                got[dt] = (np.asarray(gx, np.float32), leaves(gp))
            pcos = [cosine(a.float().numpy(), b.numpy())
                    for a, b in zip(g16[1:], g32[1:]) if b is not None]
            row["port_min_cosine"] = min(pcos)
            row["port_dx_err"] = rel_err(g16[0].float().numpy(),
                                         g32[0].numpy())
            (jx32, jg32), (jx16, jg16) = got["float32"], got["bfloat16"]
            row["jax_min_cosine"] = min(cosine(jg16[k], jg32[k])
                                        for k in jg32)
            row["jax_dx_err"] = rel_err(jx16, jx32)
            row["port_vs_jax_dx_f32"] = rel_err(g32[0].numpy(), jx32)
            rows.append(row)
            dy = g32[0]
    for p in ps:
        p.requires_grad_(False)
    out = {"blocks": len(rows)}
    for pkg in ("port", "jax"):
        worst = min(rows, key=lambda r: r[f"{pkg}_min_cosine"])
        out[f"{pkg}_block_min_cosine"] = worst[f"{pkg}_min_cosine"]
        out[f"{pkg}_block_min_cosine_at"] = f"{worst['block']} {worst['kind']}"
        out[f"{pkg}_block_dx_err"] = max(r[f"{pkg}_dx_err"] for r in rows)
        out[f"{pkg}_block_mean_1_minus_cosine"] = float(np.mean(
            [1 - r[f"{pkg}_min_cosine"] for r in rows]))
    out["port_vs_jax_block_dx_f32"] = max(r["port_vs_jax_dx_f32"]
                                          for r in rows)
    out["by_block"] = sorted(rows, key=lambda r: r["block"])
    return out


def drift(arch: str, depth: int, width_div: int, batch: int, seq: int,
          rounding: str, seed: int) -> dict:
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.model import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax

    jcfg = cut(jax_get_config(arch), depth, width_div)
    cfg = cut(get_config(arch), depth, width_div)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(seed))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    rng = np.random.default_rng(seed)
    data = {"tokens": rng.integers(0, VOCAB, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, VOCAB, (batch, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        data["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
    out = {"arch": arch, "depth": depth, "of": get_config(arch).n_layers,
           "d_model": cfg.d_model, "batch": batch, "seq": seq, "seed": seed,
           "jax_rounding": rounding}
    g = end_to_end(jcfg, jparams, cfg, params, data)
    for pkg in ("jax", "port"):
        for k, v in leaf_drift(g[pkg, "bfloat16"], g[pkg, "float32"]).items():
            out[f"{pkg}_{k}"] = v
    out["port_vs_jax_f32_max_leaf_err"] = max(
        rel_err(g["port", "float32"][k], g["jax", "float32"][k])
        for k in g["jax", "float32"] if np.any(g["jax", "float32"][k]))
    del g
    if cfg.family in ("moe", "ssm_hybrid", "xlstm"):
        out.update(block_by_block(jcfg, jparams, cfg, params, data))
    return out


def held(r: dict, margin: float) -> bool:
    ok = r["port_mean_leaf_err"] <= margin * r["jax_mean_leaf_err"]
    if "blocks" in r:
        ok &= (1 - r["port_block_min_cosine"]
               <= margin * (1 - r["jax_block_min_cosine"]))
        ok &= r["port_block_dx_err"] <= margin * r["jax_block_dx_err"]
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("depth", type=int)
    ap.add_argument("--width-div", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rounding", choices=sorted(ROUNDING), default="fused")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hold", type=float, default=None)
    args = ap.parse_args(argv)
    # XLA reads its flags once, when JAX starts its backend
    flag = f"--xla_allow_excess_precision={ROUNDING[args.rounding]}"
    os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {flag}"
    r = drift(args.arch, args.depth, args.width_div, args.batch, args.seq,
              args.rounding, args.seed)
    ok = True
    if args.hold is not None:
        r["hold"] = args.hold
        r["held"] = ok = held(r, args.hold)
    print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
