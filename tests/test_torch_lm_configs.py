"""The port's LM configs and tuning knobs against the JAX package's.

``repro_torch.configs`` is a copy of ``repro.configs`` (whose ``base.py``
imports ``jax.numpy``) and ``repro_torch.tuning`` of ``repro.tuning``: for
all ten architectures every field, ``param_count``,
``active_param_count``, ``smoke_config`` and ``layer_windows`` must equal
the JAX package's, and so must ``SHAPES`` and the knob registry.  All
comparisons are exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import tuning as jax_tuning
from repro.models import transformer as jax_transformer

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
    """The port holds the knobs it reads, with JAX's defaults; the rest of
    JAX's are named as unported, each with its ROADMAP item."""
    assert set(tuning._DEFAULTS) | set(tuning._UNPORTED) == \
        set(jax_tuning._DEFAULTS)
    assert not set(tuning._DEFAULTS) & set(tuning._UNPORTED)
    for name in tuning._DEFAULTS:
        assert tuning._DEFAULTS[name] == jax_tuning._DEFAULTS[name]
        assert tuning.get(name) == jax_tuning.get(name)


@pytest.mark.parametrize("spec", [
    "", "baseline", "q_chunk=1024;scores_dtype=bf16",
    "gqa_native=on;act_bf16=1;scores_dtype=f32", "act_bf16=false",
    " q_chunk = 64 ; gqa_native=true"])
def test_tuning_parse_matches_jax(spec):
    assert tuning.parse(spec) == jax_tuning.parse(spec)


@pytest.mark.parametrize("name", sorted(jax_tuning._DEFAULTS.keys() -
                                        tuning._DEFAULTS.keys()))
def test_tuning_unported_knobs_raise(name):
    """A JAX knob whose reader the port lacks is refused, not ignored."""
    item = tuning._UNPORTED[name]
    assert item in ("11c", "11d")
    spec = f"{name}={jax_tuning._DEFAULTS[name]}"
    jax_tuning.parse(spec)
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        tuning.parse(spec)
    with pytest.raises(NotImplementedError, match=item):
        tuning.get(name)
    with pytest.raises(NotImplementedError, match=item):
        with tuning.overrides(q_chunk=16, **{name: jax_tuning.get(name)}):
            pass
    assert tuning.get("q_chunk") == 512


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
