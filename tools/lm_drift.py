"""How far an LM's bfloat16 logits drift from its float32 logits, in the
JAX package and in the PyTorch port, on the CPU, prefill and decode.

    PYTHONPATH=src python tools/lm_drift.py ARCH DEPTH [DEPTH ...]
        [--width-div N] [--rounding fused|every-op] [--seed S]
        [--hold MARGIN]

For ARCH cut to DEPTH blocks and a 4096-token vocabulary (and, with
``--width-div N``, its d_model, d_ff, expert d_ff and head counts divided
by N, head sizes kept), with the JAX package's ``init(PRNGKey(S))``
weights (carried to the port through ``params_from_jax``) and two prompts
of 128 tokens seeded from S: the row relative L2 error of the logits
(largest and mean over the 256 rows), bfloat16 against float32, in each
package, for the prefill at every position and for ``decode`` at every
position from an empty cache (the encoder-decoder's cross-attention KV
filled by ``prefill_cross``), and between the two packages in bfloat16
and in float32 (the float32 decodes' also at every 16th position).  One
JSON line per depth.

``--rounding`` sets how XLA rounds the JAX package's bfloat16: ``fused``
is XLA's default (``--xla_allow_excess_precision=true``: on the CPU a
bfloat16 product feeding a float32 op and a fused elementwise chain keep
float32, so far fewer roundings than the program states), ``every-op``
rounds every op's result to bfloat16, as eager PyTorch does.  The port is
the same in both.  With ``--hold MARGIN`` the exit code is 1 if the port's
mean prefill or decode drift exceeds MARGIN times JAX's (the mean: the
largest of 256 rows of a chaotic stack swings with the rounding draw).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

VOCAB, BATCH, SEQ = 4096, 2, 128
ROUNDING = {"fused": "true", "every-op": "false"}


def row_errs(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (np.linalg.norm(got - want, axis=-1)
            / np.linalg.norm(want, axis=-1))


def cut(cfg, depth: int, width_div: int):
    fields = dict(n_layers=depth, vocab=VOCAB)
    if width_div > 1:
        fields.update(
            d_model=cfg.d_model // width_div, d_ff=cfg.d_ff // width_div,
            moe_d_ff=cfg.moe_d_ff // width_div,
            n_heads=max(1, cfg.n_heads // width_div),
            n_kv_heads=max(1, cfg.n_kv_heads // width_div), head_dim=cfg.hd)
    return dataclasses.replace(cfg, **fields)


def jax_hidden(cfg, params, batch):
    """The JAX package's final hidden states (B, S, d) of ``batch``."""
    from repro.models import encdec, moe, ssm, transformer, xlstm

    tokens = batch["tokens"]
    if cfg.family == "encdec":
        return encdec.decode_train(params, cfg, tokens,
                                   encdec.encode(params, cfg, batch["frames"]))
    if cfg.family == "moe":
        return moe.forward(params, cfg, tokens)[0]
    module = {"ssm_hybrid": ssm, "xlstm": xlstm}.get(cfg.family, transformer)
    return module.forward(params, cfg, tokens)


def run_jax(jcfg, jparams, tokens, frames) -> dict:
    """{(what, dtype): float32 logits (B, S, V)}: the prefill and decode
    at every position."""
    import jax
    import jax.numpy as jnp

    from repro.models import encdec as jax_encdec
    from repro.models.model import build_model as jax_build_model
    from repro.models.transformer import logits_fn

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(jcfg, dtype=dtype)
        m = jax_build_model(cfg)
        batch = {"tokens": jnp.asarray(tokens)}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames)
        out["prefill", dtype] = np.asarray(jax.jit(
            lambda p, b: logits_fn(p, cfg, jax_hidden(cfg, p, b)).astype(
                jnp.float32))(jparams, batch))
        cache = m.init_cache(BATCH, SEQ)
        if frames is not None:
            enc = jax.jit(lambda p, f: jax_encdec.encode(p, cfg, f))(
                jparams, batch["frames"])
            cache = jax_encdec.prefill_cross(jparams, cfg, enc, cache)
        step = jax.jit(m.decode)
        logits = []
        for pos in range(SEQ):
            lg, cache = step(jparams, cache, batch["tokens"][:, pos:pos + 1],
                             jnp.int32(pos))
            logits.append(np.asarray(lg.astype(jnp.float32)))
        out["decode", dtype] = np.stack(logits, axis=1)
    return out


def run_port(cfg, params, tokens, frames) -> dict:
    import torch

    from repro_torch.models import encdec
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import logits_fn

    out = {}
    tok = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype)
            m = build_model(c, device="cpu")
            batch = {"tokens": tok}
            if frames is not None:
                batch["frames"] = torch.from_numpy(frames)
            out["prefill", dtype] = logits_fn(
                params, c, m.hidden(params, batch)).float().numpy()
            cache = m.init_cache(BATCH, SEQ)
            if frames is not None:
                encdec.prefill_cross(params, c, encdec.encode(
                    params, c, batch["frames"]), cache)
            logits = []
            for pos in range(SEQ):
                lg, cache = m.decode(params, cache, tok[:, pos:pos + 1], pos)
                logits.append(lg.float().numpy())
            out["decode", dtype] = np.stack(logits, axis=1)
    return out


def drift(arch: str, depth: int, width_div: int, rounding: str,
          seed: int) -> dict:
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.model import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax

    jcfg = cut(jax_get_config(arch), depth, width_div)
    cfg = cut(get_config(arch), depth, width_div)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    frames = (rng.standard_normal((BATCH, cfg.encoder_seq, cfg.frontend_dim))
              .astype(np.float32) if cfg.family == "encdec" else None)
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    j = run_jax(jcfg, jparams, tokens, frames)
    del jparams
    p = run_port(cfg, params, tokens, frames)
    out = {"arch": arch, "depth": depth, "of": get_config(arch).n_layers,
           "d_model": cfg.d_model, "seed": seed, "jax_rounding": rounding}
    for what in ("prefill", "decode"):
        for pkg, r in (("jax", j), ("port", p)):
            errs = row_errs(r[what, "bfloat16"], r[what, "float32"])
            out[f"{pkg}_{what}_bf16_vs_f32"] = float(errs.max())
            out[f"{pkg}_{what}_bf16_vs_f32_mean"] = float(errs.mean())
            out[f"{pkg}_{what}_last_pos"] = float(errs[:, -1].max())
        for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
            errs = row_errs(p[what, dtype], j[what, dtype])
            out[f"port_vs_jax_{what}_{tag}"] = float(errs.max())
            out[f"port_vs_jax_{what}_{tag}_mean"] = float(errs.mean())
    # how the float32 decodes' gap grows along the sequence
    out["port_vs_jax_decode_f32_by_pos"] = {
        pos: float(row_errs(p["decode", "float32"][:, pos],
                            j["decode", "float32"][:, pos]).max())
        for pos in (*range(0, SEQ, 16), SEQ - 1)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("depths", type=int, nargs="+")
    ap.add_argument("--width-div", type=int, default=1)
    ap.add_argument("--rounding", choices=sorted(ROUNDING), default="fused")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hold", type=float, default=None)
    args = ap.parse_args(argv)
    # XLA reads its flags once, when JAX starts its backend
    flag = f"--xla_allow_excess_precision={ROUNDING[args.rounding]}"
    os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {flag}"
    ok = True
    for depth in args.depths:
        r = drift(args.arch, depth, args.width_div, args.rounding, args.seed)
        if args.hold is not None:
            r["hold"] = args.hold
            r["held"] = all(r[f"port_{w}_bf16_vs_f32_mean"]
                            <= args.hold * r[f"jax_{w}_bf16_vs_f32_mean"]
                            for w in ("prefill", "decode"))
            ok &= r["held"]
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
