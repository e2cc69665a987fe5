"""Constrained decoding via word-representation vocab masks.

The paper's single-word set encoding (Section 3.1) applied at vocabulary
scale: every decode-time constraint (grammar state, stop-list, retrieval
whitelist, user filter) is a packed (ceil(V/32),) bitmap; the set of tokens
allowed at a step is the *intersection* of k constraint sets — one bitwise
AND over the packed lanes (``kernels/ops.vocab_mask_and``), exactly
Algorithm 2 line 1.  The unpacked mask gates the logits.

The port's copy of the JAX package's ``serve/constrain.py``: words are
int32 bit patterns of its uint32 words (``kernels/ops.py``), and masks live
on ``device`` ("cuda" by default, resolved through ``resolve_device``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import Device, resolve_device
from ..kernels import ops


class ConstraintSet:
    """A named collection of packed vocab bitmaps on one device."""

    def __init__(self, vocab: int, device: Device = "cuda"):
        self.vocab = vocab
        self.lanes = -(-vocab // 32)
        self.device = resolve_device(device)
        self.masks = {}

    def _pack(self, allowed: np.ndarray) -> torch.Tensor:
        return ops.pack_vocab_mask(torch.from_numpy(allowed).to(self.device))

    def add_allowed(self, name: str, token_ids: np.ndarray) -> None:
        allowed = np.zeros(self.vocab, dtype=bool)
        allowed[np.asarray(token_ids, dtype=np.int64)] = True
        self.masks[name] = self._pack(allowed)

    def add_banned(self, name: str, token_ids: np.ndarray) -> None:
        allowed = np.ones(self.vocab, dtype=bool)
        allowed[np.asarray(token_ids, dtype=np.int64)] = False
        self.masks[name] = self._pack(allowed)

    def combined(self, names: Optional[Sequence[str]] = None) -> torch.Tensor:
        names = list(names or self.masks)
        stack = torch.stack([self.masks[n] for n in names])
        return ops.vocab_mask_and(stack)


def apply_mask_to_logits(logits: torch.Tensor, packed: torch.Tensor,
                         vocab: int) -> torch.Tensor:
    """(B, V) logits -> masked logits (disallowed = -inf)."""
    allowed = ops.unpack_vocab_mask(packed, vocab)
    return torch.where(allowed[None, :], logits,
                       torch.tensor(-torch.inf, dtype=logits.dtype,
                                    device=logits.device))


def constrained_greedy_token(logits: torch.Tensor, packed: torch.Tensor,
                             vocab: int) -> torch.Tensor:
    """Masked argmax; a row with every token banned gives index 0, as
    ``jnp.argmax`` does (both take the first maximum)."""
    return torch.argmax(apply_mask_to_logits(logits, packed, vocab), dim=-1)
