"""Carry parameters between the JAX package's tree and the port's modules.

The JAX package keeps a dense model's parameters as a nested dict with the
layers stacked on axis 0 (``{"embed", "layers": {"ln1": {"scale": (L, d)},
"attn": {"wq": (L, d, H, D), ...}, ...}, "ln_f", ...}``).  The port keeps
them as ``transformer.DenseParams``, whose parameter names are that tree's
paths with the layer index after ``layers`` (``layers.3.attn.wq``).  Both
directions take and give numpy arrays, so neither package imports the
other.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import Device, resolve_device
from .transformer import DenseParams

Tree = Dict[str, Any]


def _jax_path(name: str) -> Tuple[Tuple[str, ...], int]:
    """``layers.3.attn.wq`` -> (("layers", "attn", "wq"), 3); other names
    -> (their parts, -1)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), -1


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


def params_from_jax(cfg: ArchConfig, tree: Tree,
                    device: Device = "cuda") -> DenseParams:
    """The JAX package's parameter tree (numpy arrays, layers stacked on
    axis 0) -> the port's ``DenseParams`` on ``device``.  A missing, extra
    or misshapen parameter raises, naming its path."""
    dev = resolve_device(device)
    params = DenseParams(cfg, dev)
    seen = set()
    for name, p in params.named_parameters():
        path, layer = _jax_path(name)
        seen.add(path)
        arr = np.asarray(_get(tree, path))
        if layer >= 0:
            if arr.ndim == 0 or arr.shape[0] != cfg.n_layers:
                raise ValueError(
                    f"parameter {'/'.join(path)}: shape {arr.shape}, "
                    f"expected {cfg.n_layers} layers on axis 0")
            arr = arr[layer]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"parameter {'/'.join(path)}: shape {tuple(arr.shape)}, "
                f"expected {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    extra = sorted("/".join(x) for x in set(_leaves(tree)) - seen)
    if extra:
        raise ValueError(f"parameters the port does not have: {extra}")
    return params


def params_to_numpy(params: DenseParams) -> Tree:
    """The port's parameters -> the JAX package's tree layout (float32
    numpy arrays, layers stacked on axis 0)."""
    tree: Tree = {}
    stacks: Dict[Tuple[str, ...], list] = {}
    for name, p in params.named_parameters():
        path, layer = _jax_path(name)
        arr = p.detach().float().cpu().numpy()
        if layer >= 0:
            stacks.setdefault(path, []).append(arr)
        else:
            _put(tree, path, arr)
    for path, arrs in stacks.items():
        _put(tree, path, np.stack(arrs))
    return tree


def _put(tree: Tree, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
