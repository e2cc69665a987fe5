"""The port's ``chunked_xent`` and bf16 cotangent cast against the JAX
package's, on the CPU.

The same seeded hidden states (B, S, d), output embedding (V, d) and
labels go through both packages' ``chunked_xent``: the loss and its
gradients with respect to the hidden states and the embedding, with
``xent_chunk`` dividing S (several chunks) and not (one chunk of S), with
the ``grad_bf16`` knob off and on, in float32 (within ``FP32_TOL`` of
JAX's largest magnitude) and bfloat16 (``BF16_TOL``), the modes of
``tests/_torch_lm.py``.  The chunks are checkpointed: no tensor of the
(B, c, V) logits outlives the forward pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.models import layers as jax_layers

from repro_torch import tuning
from repro_torch.models import layers

from _torch_lm import BF16_TOL, FP32_TOL, assert_close

B, S, D, V = 2, 48, 24, 96
CHUNKS = {"divides": 16, "ragged": 20}      # 48 = 3 x 16; 20 -> one of 48
DTYPES = {"fp32": ("float32", FP32_TOL), "bf16": ("bfloat16", BF16_TOL)}


def inputs(dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    emb = (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    jh = jnp.asarray(h).astype(dtype)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    return ((jh, jnp.asarray(emb), jnp.asarray(labels)),
            (th, torch.from_numpy(emb), torch.from_numpy(labels.astype(np.int64))))


@pytest.mark.parametrize("grad_bf16", [False, True], ids=["ct_f32", "ct_bf16"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", DTYPES)
def test_chunked_xent_matches_jax(mode, chunk, grad_bf16):
    dtype, tol = DTYPES[mode]
    (jh, jemb, jl), (th, temb, tl) = inputs(dtype)
    knobs = dict(xent_chunk=CHUNKS[chunk], grad_bf16=grad_bf16)
    with jax_tuning.overrides(**knobs):
        jloss, (jgh, jge) = jax.jit(jax.value_and_grad(
            lambda h, e: jax_layers.chunked_xent(h, e, jl),
            argnums=(0, 1)))(jh, jemb)
    th.requires_grad_(True)
    temb.requires_grad_(True)
    with tuning.overrides(**knobs):
        loss = layers.chunked_xent(th, temb, tl)
    gh, ge = torch.autograd.grad(loss, (th, temb))
    assert loss.dtype == torch.float32
    assert gh.dtype == th.dtype and ge.dtype == torch.float32
    assert_close(loss.detach(), jloss, tol)
    assert_close(gh, jgh, tol)
    assert_close(ge, jge, tol)


def test_ct_cast_bf16_casts_only_the_cotangent():
    x = torch.randn(3, 5, dtype=torch.bfloat16, requires_grad=True)
    y = layers._ct_cast_bf16(x)
    assert torch.equal(y, x)
    seen = []
    y.register_hook(lambda g: seen.append(g.dtype))
    g, = torch.autograd.grad((y.float() * 3.0).sum(), x)
    assert g.dtype == torch.bfloat16 and torch.all(g == 3.0)
    # the identity's own backward returns bf16 whatever arrives
    ct = layers._CtCastBf16.backward(None, torch.ones(2, dtype=torch.float32))
    assert ct.dtype == torch.bfloat16


def test_chunked_xent_keeps_no_logits():
    """Every tensor the forward pass leaves for backward is smaller than
    one chunk's (B, c, V) logits: each chunk recomputes its own."""
    (_, _, _), (th, temb, tl) = inputs("float32")
    th.requires_grad_(True)
    temb.requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with tuning.overrides(xent_chunk=16):
            loss = layers.chunked_xent(th, temb, tl)
    assert saved and max(saved) < B * 16 * V
    loss.backward()
    assert th.grad is not None and temb.grad is not None
