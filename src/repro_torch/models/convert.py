"""Carry parameters between the JAX package's tree and the port's modules.

The JAX package keeps a model's parameters as a nested dict whose layer
lists are stacked on leading axes (``{"embed", "layers": {"ln1": {"scale":
(L, d)}, "attn": {"wq": (L, d, H, D), ...}, ...}, "ln_f", ...}``).  The
port keeps them as one ``nn.Module`` per family (``DenseParams``,
``MoEParams``, ``SSMParams``, ``XLSTMParams``, ``EncDecParams``), whose
parameter names are that tree's paths with the stack indices after the
list's name: ``layers.3.attn.wq``, ``moe_layers.0.moe.w_up``, and
``mlstm.2.1.wq`` for xLSTM's mLSTM blocks, stacked on two axes (rounds,
blocks per round).  Both directions take and give numpy arrays, so
neither package imports the other.  ``named_to_numpy`` / ``load_named_``
do the same for any tensors keyed by those names (AdamW's ``m`` and ``v``,
gradients), and ``stacked_rank`` gives a parameter's rank in the JAX tree.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from . import encdec, moe, ssm, xlstm
from .transformer import DenseParams

Tree = Dict[str, Any]

# the stacked layer lists of the JAX trees, and the axes each is stacked on
_STACKS = {"layers": 1, "dense_layers": 1, "moe_layers": 1,
           "enc_layers": 1, "dec_layers": 1, "slstm": 1, "mlstm": 2}

PARAMS = {"dense": DenseParams, "vlm": DenseParams, "moe": moe.MoEParams,
          "ssm_hybrid": ssm.SSMParams, "xlstm": xlstm.XLSTMParams,
          "encdec": encdec.EncDecParams}


def _jax_path(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``layers.3.attn.wq`` -> (("layers", "attn", "wq"), (3,));
    ``mlstm.2.1.wq`` -> (("mlstm", "wq"), (2, 1)); other names -> (their
    parts, ())."""
    parts = name.split(".")
    n = _STACKS.get(parts[0], 0)
    return ((parts[0],) + tuple(parts[1 + n:]),
            tuple(int(i) for i in parts[1:1 + n]))


def stacked_rank(name: str, tensor: torch.Tensor) -> int:
    """The rank of parameter ``name``'s leaf in the JAX tree: the port's
    rank plus the axes its layer list is stacked on."""
    return tensor.ndim + len(_jax_path(name)[1])


def _stack_shapes(names: Iterable[str]) -> Dict[str, Tuple[int, ...]]:
    """The leading axes the JAX tree stacks each layer list on, from the
    indices in the port's names."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name in names:
        path, idx = _jax_path(name)
        if idx:
            old = shapes.get(path[0], (0,) * len(idx))
            shapes[path[0]] = tuple(max(a, i + 1) for a, i in zip(old, idx))
    return shapes


def _leaves(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree: Tree, path: Tuple[str, ...]):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(f"parameter {'/'.join(path)} missing from the tree")
        tree = tree[k]
    return tree


def load_named_(named: Iterable[Tuple[str, torch.Tensor]],
                tree: Tree) -> None:
    """Copy the JAX tree's leaves (numpy arrays, layer lists stacked on
    leading axes) into the tensors ``named`` (port names, row-major over
    each list, as ``named_parameters`` walks them), in place.  A missing,
    extra or misshapen leaf raises ``KeyError`` / ``ValueError``, naming
    its path."""
    named = list(named)
    stacks = _stack_shapes(n for n, _ in named)
    seen = set()
    with torch.no_grad():
        for name, p in named:
            path, idx = _jax_path(name)
            seen.add(path)
            arr = np.asarray(_get(tree, path))
            if idx:
                stack = stacks[path[0]]
                if tuple(arr.shape[:len(stack)]) != stack:
                    raise ValueError(
                        f"parameter {'/'.join(path)}: shape {arr.shape}, "
                        f"expected {stack} layers on the leading axes")
                arr = arr[idx]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"parameter {'/'.join(path)}: shape {tuple(arr.shape)}, "
                    f"expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    extra = sorted("/".join(x) for x in set(_leaves(tree)) - seen)
    if extra:
        raise ValueError(f"parameters the port does not have: {extra}")


def params_from_jax(cfg: ArchConfig, tree: Tree,
                    device: Device = "cuda") -> torch.nn.Module:
    """The JAX package's parameter tree (numpy arrays, layer lists stacked
    on leading axes) -> the port's parameter module for ``cfg.family`` on
    ``device``.  A missing, extra or misshapen parameter raises, naming its
    path."""
    params = PARAMS[cfg.family](cfg, resolve_device(device))
    load_named_(params.named_parameters(), tree)
    return params


def named_to_numpy(named: Iterable[Tuple[str, torch.Tensor]]) -> Tree:
    """Tensors keyed by port names (row-major over each layer list) -> the
    JAX package's tree layout (float32 numpy arrays, layer lists stacked on
    leading axes)."""
    named = list(named)
    shapes = _stack_shapes(n for n, _ in named)
    tree: Tree = {}
    stacks: Dict[Tuple[str, ...], list] = {}
    for name, p in named:
        path, idx = _jax_path(name)
        arr = p.detach().float().cpu().numpy()
        if idx:
            stacks.setdefault(path, []).append(arr)
        else:
            _put(tree, path, arr)
    for path, arrs in stacks.items():
        _put(tree, path, np.stack(arrs).reshape(shapes[path[0]]
                                                + arrs[0].shape))
    return tree


def params_to_numpy(params: torch.nn.Module) -> Tree:
    """The port's parameters -> the JAX package's tree layout (float32
    numpy arrays, layer lists stacked on leading axes)."""
    return named_to_numpy(params.named_parameters())


def _put(tree: Tree, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
