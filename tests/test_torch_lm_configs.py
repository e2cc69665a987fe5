"""The port's LM configs and tuning knobs against the JAX package's.

``repro_torch.configs`` is a copy of ``repro.configs`` (whose ``base.py``
imports ``jax.numpy``) and ``repro_torch.tuning`` of ``repro.tuning``: for
all ten architectures every field, ``param_count``,
``active_param_count``, ``smoke_config`` and ``layer_windows`` must equal
the JAX package's, and so must ``SHAPES`` and the knob registry.  All
comparisons are exact.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import tuning as jax_tuning
from repro.models import transformer as jax_transformer
from repro.train import step as jax_step

from repro_torch import configs, tuning
from repro_torch.models import transformer


def test_registry_matches_jax():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_jax(arch, smoke):
    jcfg = jax_configs.get_config(arch)
    cfg = configs.get_config(arch)
    if smoke:
        jcfg, cfg = jax_configs.smoke_config(jcfg), configs.smoke_config(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.hd == jcfg.hd
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.activation_dtype == getattr(torch, jnp.dtype(jcfg.dtype).name)
    assert cfg.p_dtype == getattr(torch, jnp.dtype(jcfg.param_dtype).name)
    assert list(transformer.layer_windows(cfg)) == \
        np.asarray(jax_transformer.layer_windows(jcfg)).tolist()


def test_gemma3_windows_are_five_local_one_global():
    wins = transformer.layer_windows(configs.get_config("gemma3-12b"))
    assert wins[:6] == (1024,) * 5 + (0,)
    assert wins.count(0) == 8


def test_shapes_match_jax():
    assert [dataclasses.asdict(s) for s in configs.SHAPES] == \
        [dataclasses.asdict(s) for s in jax_configs.SHAPES]
    for s in jax_configs.SHAPES:
        assert dataclasses.asdict(configs.shape_by_name(s.name)) == \
            dataclasses.asdict(s)
    with pytest.raises(KeyError):
        configs.shape_by_name("no-such-shape")


def test_qwen3_full_width_is_1_72b_parameters():
    cfg = configs.get_config("qwen3-1.7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab) == (28, 2048, 16, 8, 128, 6144, 151936)
    assert 1.70e9 < cfg.param_count() < 1.74e9


def test_tuning_registry_matches_jax():
    """The port holds every one of JAX's knobs, with JAX's defaults, and
    refuses a name JAX does not know."""
    assert set(tuning._DEFAULTS) == set(jax_tuning._DEFAULTS)
    with pytest.raises(KeyError, match="unknown tuning knob"):
        tuning.get("no_such_knob")
    for name in tuning._DEFAULTS:
        assert tuning._DEFAULTS[name] == jax_tuning._DEFAULTS[name]
        assert tuning.get(name) == jax_tuning.get(name)


@pytest.mark.parametrize("spec", [
    "", "baseline", "q_chunk=1024;scores_dtype=bf16",
    "gqa_native=on;act_bf16=1;scores_dtype=f32", "act_bf16=false",
    " q_chunk = 64 ; gqa_native=true",
    "xent_chunk=128;remat=dots;grad_bf16=on",
    "capacity_factor=1.5;q_chunk=8"])
def test_tuning_parse_matches_jax(spec):
    assert tuning.parse(spec) == jax_tuning.parse(spec)


def _knob_setting(name: str) -> str:
    """A setting of ``name`` other than its default, as a parse string."""
    proto = jax_tuning._DEFAULTS[name]
    if isinstance(proto, bool):
        return "on" if not proto else "off"
    if isinstance(proto, (int, float)):
        return str(proto * 2 or 1.5)
    return {"scores_dtype": "bf16", "remat": "dots"}[name]


@pytest.mark.parametrize("name", sorted(jax_tuning._DEFAULTS))
def test_every_jax_knob_is_the_ports(name):
    """Every knob of the JAX package is the port's, with JAX's default,
    and parses as JAX's does, alone and beside another knob."""
    assert tuning._DEFAULTS[name] == jax_tuning._DEFAULTS[name]
    assert tuning.get(name) == jax_tuning.get(name)
    for spec in (f"{name}={_knob_setting(name)}",
                 f"q_chunk=16; {name} = {_knob_setting(name)}"):
        assert tuning.parse(spec) == jax_tuning.parse(spec)
        assert tuning.parse(spec)[name] != tuning._DEFAULTS[name]
    with tuning.overrides(**tuning.parse(f"{name}={_knob_setting(name)}")):
        assert tuning.get(name) != jax_tuning.get(name)
    assert tuning.get(name) == jax_tuning.get(name)


TRAINING_KNOBS = {"xent_chunk": 4, "remat": "dots", "grad_bf16": True,
                  "micro_tokens": 4096}


def _knob_readers(monkeypatch) -> dict:
    """What each training knob's reader did on a bf16 ``chunked_xent`` of
    S 8 (and a ``remat_wrap``): chunks checkpointed, cotangent casts
    applied, and whether the wrapped function is the function itself."""
    from repro_torch.models import layers

    seen = {"xent_chunk": 0, "grad_bf16": 0}
    checkpoint, cast = layers.checkpoint, layers._CtCastBf16.apply

    def counted_checkpoint(*a, **kw):
        seen["xent_chunk"] += 1
        return checkpoint(*a, **kw)

    def counted_cast(x):
        seen["grad_bf16"] += 1
        return cast(x)

    monkeypatch.setattr(layers, "checkpoint", counted_checkpoint)
    monkeypatch.setattr(layers._CtCastBf16, "apply", counted_cast)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(2, 8, 16, generator=gen).to(torch.bfloat16)
    emb = torch.randn(32, 16, generator=gen)
    layers.chunked_xent(h, emb, torch.randint(0, 32, (2, 8), generator=gen))

    def f(x):
        return x
    seen["remat"] = tuning.remat_wrap(f) is not f
    from repro_torch.core.engine import make_mesh2d
    from repro_torch.train.step import auto_microbatch

    seen["micro_tokens"] = auto_microbatch(8, 4096, make_mesh2d(
        1, 1, data_axis="data", shard_axis="model", devices=["cpu"]))
    return seen


@pytest.mark.parametrize("name", sorted(TRAINING_KNOBS))
def test_tuning_training_knobs_are_read(name, monkeypatch):
    """The training knobs (ROADMAP 11c, ported; ``micro_tokens`` with the
    dry run, 11e) are accepted with JAX's defaults and typed by parse as
    JAX's are, and each one's setting changes what its reader does:
    ``xent_chunk`` 4 cuts S 8 into two checkpointed chunks (one at the
    default 256), ``grad_bf16`` casts the cotangent once (never by
    default), ``remat`` "dots" wraps as "full" does (and "none" returns
    the function itself), ``micro_tokens`` 4096 makes ``auto_microbatch``
    split 8 x 4096 tokens on one device into 8 microbatches (4 at the
    default 8192)."""
    assert name in tuning._DEFAULTS
    assert tuning.get(name) == jax_tuning._DEFAULTS[name]
    value = TRAINING_KNOBS[name]
    spec = f"{name}={value}"
    assert tuning.parse(spec) == jax_tuning.parse(spec) == {name: value}
    want = {"xent_chunk": (1, 2), "grad_bf16": (0, 1), "remat": (True, True),
            "micro_tokens": (4, 8)}
    with monkeypatch.context() as mp:
        assert _knob_readers(mp)[name] == want[name][0]
    with tuning.overrides(**{name: value}), monkeypatch.context() as mp:
        assert tuning.get(name) == value
        assert _knob_readers(mp)[name] == want[name][1]
    if name == "remat":
        with tuning.overrides(remat="none"), monkeypatch.context() as mp:
            assert _knob_readers(mp)["remat"] is False


def test_remat_wrap_follows_the_knob():
    """``remat_wrap`` gives the function itself at "none", a checkpointed
    one that computes the same value and gradient at "full" and "dots",
    and refuses another mode when it wraps."""
    def f(x):
        return torch.sin(x @ x.T).sum()

    x = torch.randn(4, 4, dtype=torch.float64, requires_grad=True)
    want = torch.autograd.grad(f(x), x)[0]
    with tuning.overrides(remat="none"):
        assert tuning.remat_wrap(f) is f
    for mode in ("full", "dots"):
        with tuning.overrides(remat=mode):
            g = tuning.remat_wrap(f)
        assert g is not f
        assert torch.equal(torch.autograd.grad(g(x), x)[0], want)
    with tuning.overrides(remat="everything"):
        with pytest.raises(ValueError, match="full, dots or none"):
            tuning.remat_wrap(f)


def test_mesh_and_fsdp_are_refused(tmp_path):
    """The four calls this test held refused before training over a mesh
    was ported, and what each does now: ``build_train_step`` over a mesh
    returns the state's specs and a step that enters the mesh; ``fsdp=True``
    changes the specs only; ``train(mesh=)`` trains; ``restore(shardings=)``
    places the state, and refuses a spec that cannot lay out its leaf.
    ``auto_microbatch`` came with the dry run (11e): JAX's factor."""
    from repro_torch.core.engine import make_mesh2d
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import ctx
    from repro_torch.parallel.sharding import NamedSharding, PartitionSpec
    from repro_torch.train import checkpoint, loop, step

    cfg = configs.smoke_config(configs.get_config("qwen3-1.7b"))
    model = build_model(cfg, device="cpu")
    mesh = make_mesh2d(2, 2, data_axis="data", shard_axis="model",
                       devices=["cpu"] * 4)
    seen = []

    def loss(params, batch):
        seen.append(ctx.current_mesh())
        return model.loss(params, batch)
    watched = dataclasses.replace(model, loss=loss)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    fn, (p_specs, o_specs), _ = step.build_train_step(watched, mesh=mesh,
                                                      opt_cfg=opt)
    fn_f, (p_specs_f, _), _ = step.build_train_step(watched, mesh=mesh,
                                                    opt_cfg=opt, fsdp=True)
    names = [n for n, _ in model.init(torch.Generator()).named_parameters()]
    assert list(p_specs) == list(o_specs.m) == list(o_specs.v) == names
    assert o_specs.step == PartitionSpec()
    assert p_specs != p_specs_f           # FSDP shards over `data` too
    assert step.build_train_step(model, fsdp=True)[1] == (None, None)
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
          SyntheticLMData(cfg.vocab, 2, 8, seed=0).batch_at(0).items()}
    outs = []
    for f in (fn, fn_f):
        params = model.init(torch.Generator().manual_seed(0))
        outs.append(f(params, adamw.init(opt, params), tb))
    assert seen == [mesh, mesh] and ctx.current_mesh() is None
    assert torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])
    out = loop.train(model, SyntheticLMData(cfg.vocab, 2, 8, seed=0),
                     loop.LoopConfig(steps=1, ckpt_dir=str(tmp_path)),
                     log_fn=lambda *_: None, mesh=mesh)
    assert out["final_step"] == 1
    like = {"params": step.abstract_params(model)}
    shard = {"params": {n: NamedSharding(mesh, s)
                        for n, s in p_specs_f.items()}}
    _, got, _ = checkpoint.restore(str(tmp_path), like, shardings=shard)
    assert got["params"].embed.device.type == "cpu"
    shard["params"]["embed"] = NamedSharding(mesh, PartitionSpec("pod"))
    with pytest.raises(ValueError, match="lacks"):
        checkpoint.restore(str(tmp_path), like, shardings=shard)
    assert not step.needs_fsdp(model)
    # 11e, with the dry run: JAX's factor over the port's mesh
    assert step.auto_microbatch(256, 4096, mesh) == \
        jax_step.auto_microbatch(256, 4096, types.SimpleNamespace(
            axis_names=mesh.axis_names, shape=dict(mesh.shape))) == 64


def test_tuning_overrides_and_scores_dtype():
    assert tuning.scores_dtype() == torch.float32
    with tuning.overrides(scores_dtype="bf16", q_chunk=16):
        assert tuning.scores_dtype() == torch.bfloat16
        assert tuning.get("q_chunk") == 16
    assert tuning.get("q_chunk") == 512
    assert tuning.scores_dtype() == torch.float32
    with pytest.raises(KeyError, match="unknown tuning knob"):
        with tuning.overrides(no_such_knob=1):
            pass
