"""The port's vocab masks against the JAX package's, bit for bit.

``pack_vocab_mask``, ``unpack_vocab_mask`` and ``vocab_mask_and``
(``repro_torch/kernels/ops.py``) keep the JAX package's uint32 words as
int32 bit patterns, so ``words.numpy().view(np.uint32)`` must equal JAX's
words exactly, bit 31 included; ``ConstraintSet``, ``apply_mask_to_logits``
and ``constrained_greedy_token`` must give JAX's masks, masked logits and
tokens exactly, a row with every token banned included (index 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.serve import constrain as jax_constrain

from repro_torch.kernels import ops
from repro_torch.serve import constrain

VOCABS = (1, 31, 32, 33, 100, 151936)


def words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def random_allowed(rng, v, density):
    allowed = rng.random(v) < density
    if v >= 32:
        allowed[31] = True        # bit 31 of word 0: a negative int32 word
    return allowed


@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_pack_unpack_match_jax(v, density):
    rng = np.random.default_rng(v)
    allowed = rng.random(v) < density
    got = ops.pack_vocab_mask(torch.from_numpy(allowed))
    want = np.asarray(jax_ops.pack_vocab_mask(jnp.asarray(allowed)))
    assert got.dtype == torch.int32 and got.shape == (-(-v // 32),)
    np.testing.assert_array_equal(words(got), want)
    np.testing.assert_array_equal(ops.unpack_vocab_mask(got, v).numpy(),
                                  allowed)
    np.testing.assert_array_equal(
        ops.unpack_vocab_mask(got, v).numpy(),
        np.asarray(jax_ops.unpack_vocab_mask(jnp.asarray(want), v)))


def test_bit_31_round_trips():
    allowed = np.zeros(64, dtype=bool)
    allowed[31] = allowed[63] = allowed[0] = True
    got = ops.pack_vocab_mask(torch.from_numpy(allowed))
    assert got.tolist() == [-(1 << 31) + 1, -(1 << 31)]
    np.testing.assert_array_equal(words(got), [0x80000001, 0x80000000])
    np.testing.assert_array_equal(ops.unpack_vocab_mask(got, 64).numpy(),
                                  allowed)


@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_vocab_mask_and_matches_jax(v, k):
    rng = np.random.default_rng(1000 * k + v)
    stack = np.stack([random_allowed(rng, v, 0.7) for _ in range(k)])
    packed = torch.stack([ops.pack_vocab_mask(torch.from_numpy(a))
                          for a in stack])
    jpacked = jnp.stack([jax_ops.pack_vocab_mask(jnp.asarray(a))
                         for a in stack])
    got = ops.vocab_mask_and(packed)
    np.testing.assert_array_equal(
        words(got), np.asarray(jax_ops.vocab_mask_and(jpacked)))
    np.testing.assert_array_equal(ops.unpack_vocab_mask(got, v).numpy(),
                                  stack.all(axis=0))


@pytest.mark.parametrize("v", [100, 512, 151936])
def test_constraint_set_matches_jax(v):
    rng = np.random.default_rng(v)
    allowed_a = rng.choice(v, v // 2, replace=False)
    allowed_b = rng.choice(v, v // 2, replace=False)
    banned = np.arange(min(10, v))
    port = constrain.ConstraintSet(v, device="cpu")
    ref = jax_constrain.ConstraintSet(v)
    for cs in (port, ref):
        cs.add_allowed("a", allowed_a)
        cs.add_allowed("b", allowed_b)
        cs.add_banned("stop", banned)
    assert port.lanes == ref.lanes
    for name in ("a", "b", "stop"):
        np.testing.assert_array_equal(words(port.masks[name]),
                                      np.asarray(ref.masks[name]))
    for names in (None, ["a"], ["a", "stop"]):
        np.testing.assert_array_equal(words(port.combined(names)),
                                      np.asarray(ref.combined(names)))
    want = set(np.intersect1d(allowed_a, allowed_b).tolist()) - set(
        banned.tolist())
    got = ops.unpack_vocab_mask(port.combined(), v).numpy()
    assert set(np.flatnonzero(got).tolist()) == want


@pytest.mark.parametrize("v", [100, 151936])
def test_masked_logits_and_greedy_token_match_jax(v):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, v)).astype(np.float32)
    port = constrain.ConstraintSet(v, device="cpu")
    ref = jax_constrain.ConstraintSet(v)
    allowed = rng.choice(v, 40, replace=False)
    for cs in (port, ref):
        cs.add_allowed("only", allowed)
    masked = constrain.apply_mask_to_logits(torch.from_numpy(logits),
                                            port.combined(), v)
    jmasked = jax_constrain.apply_mask_to_logits(jnp.asarray(logits),
                                                 ref.combined(), v)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jmasked))
    tok = constrain.constrained_greedy_token(torch.from_numpy(logits),
                                             port.combined(), v)
    jtok = jax_constrain.constrained_greedy_token(jnp.asarray(logits),
                                                  ref.combined(), v)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert set(tok.tolist()) <= set(allowed.tolist())


def test_all_banned_row_gives_token_zero_as_jax():
    v = 100
    port = constrain.ConstraintSet(v, device="cpu")
    ref = jax_constrain.ConstraintSet(v)
    for cs in (port, ref):
        cs.add_banned("all", np.arange(v))
    logits = np.random.default_rng(3).standard_normal((2, v)).astype(
        np.float32)
    masked = constrain.apply_mask_to_logits(torch.from_numpy(logits),
                                            port.combined(), v)
    assert torch.isneginf(masked).all()
    tok = constrain.constrained_greedy_token(torch.from_numpy(logits),
                                             port.combined(), v)
    jtok = jax_constrain.constrained_greedy_token(jnp.asarray(logits),
                                                  ref.combined(), v)
    assert tok.tolist() == np.asarray(jtok).tolist() == [0, 0]


def test_constraint_set_on_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        constrain.ConstraintSet(100)
    with pytest.raises(RuntimeError, match="cuda"):
        constrain.ConstraintSet(100, device="cuda")
