"""Sharding rules: name + shape pattern -> partition spec, for every family.

The port's copy of the JAX package's ``parallel/sharding.py``.  Mesh axes
are roles: ``data`` (+ ``pod`` when present) = DP/FSDP, ``model`` =
TP/EP/SP.  Rules are written against *trailing* dimensions (negative
indices).  Every candidate axis is divisibility-checked against the mesh:
if a preferred dim does not divide, the next candidate is tried, and
ultimately the dim is replicated, so one rule table serves all ten
architectures (kv-head sharding applies only where kv % tp == 0;
starcoder2's kv=4 falls back to replicated kv projections).

The spec functions read only ``mesh.shape`` and ``mesh.axis_names``, so
they take the port's ``Mesh`` or any object with those two.  Parameters
are matched by their JAX path: the port's ``layers.3.attn.wq`` reads as
``layers/attn/wq`` (``models/convert.py::_jax_path``), and its spec is the
reference's for the stacked (L, d, H, D) leaf with the leading layer axes
dropped; no rule shards a stacked axis, and one that did would raise.
AdamW's ``m`` and ``v`` are keyed by the same names.  Caches and batches
are dicts of tensors in the reference's layout, so their rules apply
unchanged.  A spec is a ``ctx.PartitionSpec``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Tuple, Union

import torch

from ..models.convert import _jax_path, _stack_shapes
from .ctx import PartitionSpec, dp_axes

Axes = Union[str, Tuple[str, ...], None]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what a tensor's layout over the mesh would be."""
    mesh: Any
    spec: PartitionSpec


def tp_axis(mesh) -> str:
    return "model"


def _size(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def assign_spec(shape, prefs: List[Tuple[Axes, int]], mesh) -> PartitionSpec:
    """Greedy: for each (axes, negative_dim) preference, attach `axes` to
    that dim if the dim exists, divides, and neither the dim nor the axes
    are already used."""
    ndim = len(shape)
    out: List[Axes] = [None] * ndim
    used: set = set()
    for axes, nd in prefs:
        if axes is None:
            continue
        dim = ndim + nd
        if dim < 0 or dim >= ndim or out[dim] is not None:
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        ax_tuple = tuple(a for a in ax_tuple
                         if a in mesh.axis_names and a not in used)
        if not ax_tuple:
            continue
        if shape[dim] % _size(mesh, ax_tuple) != 0:
            # try a shrinking suffix of the axis tuple
            while len(ax_tuple) > 1 and shape[dim] % _size(mesh, ax_tuple) != 0:
                ax_tuple = ax_tuple[1:]
            if shape[dim] % _size(mesh, ax_tuple) != 0:
                continue
        out[dim] = ax_tuple if len(ax_tuple) > 1 else ax_tuple[0]
        used.update(ax_tuple)
    return PartitionSpec(*out)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

def param_rules(fsdp: bool, dp: Tuple[str, ...]):
    """Ordered (regex over path, prefs) — first match wins.

    prefs are [(axes, trailing_dim), ...]; "model" = TP/EP, dp = FSDP.
    """
    f: Axes = dp if fsdp else None
    return [
        # MoE experts (E, d, ff): EP on experts + FSDP on d
        (r"moe/(w_gate|w_up)$", [("model", -3), (f, -2)]),
        (r"moe/w_down$", [("model", -3), (f, -1)]),
        (r"moe/router$", [(f, -2)]),
        (r"moe/shared/(w_gate|w_up)$", [("model", -1), (f, -2)]),
        (r"moe/shared/w_down$", [("model", -2), (f, -1)]),
        # embeddings (V, d): vocab-sharded (chunked xent) + FSDP on d
        (r"(embed|unembed)$", [("model", -2), (f, -1)]),
        (r"(patch_proj|frontend_proj)$", [("model", -1)]),
        # attention (d, H, hd) / (H, hd, d): heads on TP, d on FSDP
        (r"attn/w(q|k|v)$", [("model", -2), (f, -3)]),
        (r"attn/wo$", [("model", -3), (f, -1)]),
        (r"xattn/w(q|k|v)$", [("model", -2), (f, -3)]),
        (r"xattn/wo$", [("model", -3), (f, -1)]),
        # dense MLP (d, ff) / (ff, d)
        (r"mlp/(w_gate|w_up)$", [("model", -1), (f, -2)]),
        (r"mlp/w_down$", [("model", -2), (f, -1)]),
        # mamba
        (r"mamba/w_in$", [("model", -1), (f, -2)]),
        (r"mamba/w_out$", [("model", -2), (f, -1)]),
        (r"mamba/conv$", [("model", -1)]),
        # xlstm
        (r"(mlstm|slstm).*/w_(up|x)$", [("model", -1), (f, -2)]),
        (r"(mlstm|slstm).*/w(q|k)$", [("model", -1), (f, -2)]),
        (r"(mlstm|slstm).*/w_if$", [(f, -2)]),
        (r"(mlstm|slstm).*/w_h$", [("model", -3)]),
        (r"(mlstm|slstm).*/w_down$", [("model", -2), (f, -1)]),
        # norms / scalars: replicated
        (r".*", []),
    ]


def _named(tree) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.named_parameters())
    return list(tree.items())


def param_pspecs(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                 mesh, fsdp: bool = False) -> Dict[str, PartitionSpec]:
    """Each parameter's spec, keyed by the port's names: ``params`` is a
    parameter module (on any device, ``meta`` included) or tensors keyed
    by its names (AdamW's ``m`` / ``v``)."""
    rules = [(re.compile(pat), prefs) for pat, prefs in
             param_rules(fsdp, dp_axes(mesh))]
    named = _named(params)
    stacks = _stack_shapes(n for n, _ in named)
    out = {}
    for name, t in named:
        path, idx = _jax_path(name)
        ps = "/".join(path)
        lead = stacks[path[0]] if idx else ()
        prefs = next(prefs for pat, prefs in rules if pat.search(ps))
        spec = assign_spec(lead + tuple(t.shape), prefs, mesh)
        if any(spec[:len(lead)]):
            raise ValueError(f"{ps}: spec {spec} shards a stacked layer axis")
        out[name] = PartitionSpec(*spec[len(lead):])
    return out


# --------------------------------------------------------------------------
# activation / batch / cache rules
# --------------------------------------------------------------------------

def batch_pspecs(batch: Mapping[str, torch.Tensor],
                 mesh) -> Dict[str, PartitionSpec]:
    """Inputs: batch dim over DP axes (skipped automatically when B=1 via
    divisibility), everything else replicated — except the long-context
    case (B=1) where the *sequence* dim is sharded over DP (sequence/
    context parallelism)."""
    dp = dp_axes(mesh)

    def leaf_spec(shape) -> PartitionSpec:
        if len(shape) == 0:
            return PartitionSpec()
        prefs = [(dp, -len(shape))]  # dim 0 = batch
        if len(shape) >= 2 and shape[0] == 1:
            prefs.append((dp, -len(shape) + 1))  # shard seq instead
        return assign_spec(shape, prefs, mesh)

    return {name: leaf_spec(tuple(t.shape)) for name, t in batch.items()}


def cache_pspecs(cache: Mapping[str, torch.Tensor],
                 mesh) -> Dict[str, PartitionSpec]:
    """KV caches (L, B, S, K, D): batch over DP, sequence over TP (SP for
    decode — the attention reduction over shards becomes partial softmax +
    psum).  Recurrent states (mamba/xlstm): batch over DP, heads over TP."""
    dp = dp_axes(mesh)

    def leaf_spec(ps: str, shape) -> PartitionSpec:
        if re.search(r"(^|/)(k|v|xk|xv)$", ps) and len(shape) >= 4:
            # (..., B, S, K, D)
            prefs = [(dp, -4), ("model", -3)]
            if shape[-4] == 1:
                # B=1 long-context: SP over every axis at once (256/512-way)
                prefs = [(("model",) + dp, -3)]
            return assign_spec(shape, prefs, mesh)
        if re.search(r"(ssm|conv|m_state|s_h|s_c)$", ps):
            # family layouts: ssm (L,B,nh,ns,hp): B=-4, nh=-3; conv (L,B,4,d)
            if ps.endswith("conv"):
                prefs = [(dp, -3), ("model", -1)]
            elif ps.endswith("m_state"):
                prefs = [(dp, -4), ("model", -3)]
            elif ps.endswith("ssm"):
                prefs = [(dp, -4), ("model", -3)]
            else:  # s_h / s_c (rounds, B, nh, hd)
                prefs = [(dp, -3), ("model", -2)]
            return assign_spec(shape, prefs, mesh)
        return PartitionSpec()

    return {name: leaf_spec(name, tuple(t.shape)) for name, t in cache.items()}


def shardings_of(tree: Mapping[str, Any], pspecs: Mapping[str, PartitionSpec],
                 mesh) -> Dict[str, NamedSharding]:
    return {name: NamedSharding(mesh, pspecs[name]) for name in tree}
