"""Fault-tolerant checkpointing, in the JAX package's on-disk layout.

The port's copy of the JAX package's ``train/checkpoint.py``; either
package restores the other's checkpoints:
  * ``<dir>/step_%08d/{<name>.npz, manifest.json}``, written under
    ``<dir>/tmp.<step>.<pid>.<hex>`` and then one atomic ``os.replace``,
    so a crash mid-write never corrupts the latest checkpoint;
  * one ``.npy`` blob a leaf, keyed by its JAX tree path joined by ``//``,
    layer lists stacked on leading axes (``layers//attn//wq`` is
    (L, d, H, D); ``models/convert.py`` maps the port's names); an
    ``AdamWState``'s keys are ``.step``, ``.m//...`` and ``.v//...`` (the
    ``str`` of JAX's ``GetAttrKey``);
  * an async writer thread overlaps serialisation with the next train
    steps (the state is copied to the host first);
  * ``install_preemption_handler`` turns SIGTERM (the cloud preemption
    signal) into a flag the loop answers with a synchronous save.

A state tree is a dict of: a parameter module (``nn.Module``), an
``AdamWState``, or nested dicts / lists of tensors or numpy arrays.  Leaves
are written as float32 (a bf16 optimizer state included: numpy has no
bf16; restore casts back).

``restore(..., shardings=)`` takes, for some of the state's names, a tree
of ``parallel.sharding.NamedSharding``s shaped like the state: a dict
keyed by parameter names for a parameter module (as ``shardings_of``
gives), an ``AdamWState`` of them for an optimizer state
(``train/elastic.py::remesh`` builds both); shardings of any other tree
raise ``ValueError``.  Each spec is checked against
its leaf's shape and its mesh as ``jax.device_put`` checks it: an axis the
mesh lacks, an axis used twice, or axes whose product does not divide the
dimension raise ``ValueError``.  A deliberate difference from the
reference: there is no GSPMD, so a spec is a description, and the tree is
placed whole on the device at its meshes' coordinate (0, ..., 0), where
the sharded stages read whole tensors (``models/moe.py``).
"""
from __future__ import annotations

import copy
import json
import os
import pathlib
import queue
import re
import shutil
import signal
import threading
import time
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import Device, resolve_device
from ..models.convert import load_named_, named_to_numpy
from ..optim.adamw import AdamWState
from ..parallel.sharding import NamedSharding

SEP = "//"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Leaf key -> numpy array, the keys JAX's ``_flatten`` gives."""
    def key(k) -> str:
        return f"{prefix}{SEP}{k}" if prefix else str(k)

    if isinstance(tree, nn.Module):
        return _flatten(named_to_numpy(tree.named_parameters()), prefix)
    if isinstance(tree, AdamWState):
        return {key(".step"): _host(tree.step),
                **_flatten(named_to_numpy(tree.m.items()), key(".m")),
                **_flatten(named_to_numpy(tree.v.items()), key(".v"))}
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flatten(sub, key(name)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flatten(sub, key(i)).items()}
    return {prefix: _host(tree)}


def _nest(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    """The leaves under ``prefix`` (all of them for "") as a nested dict
    of their paths."""
    head = prefix + SEP if prefix else ""
    out: dict = {}
    for k, v in flat.items():
        if k.startswith(head):
            node = out
            *path, last = k[len(head):].split(SEP)
            for part in path:
                node = node.setdefault(part, {})
            node[last] = v
    return out


def _leaf(flat: Dict[str, np.ndarray], key: str, shape) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(shape)}")
    return arr


def _materialise(like: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, device=device)


def _unflatten(like: Any, flat: Dict[str, np.ndarray], device,
               prefix: str = "") -> Any:
    """A new state shaped like ``like`` (meta tensors will do), filled
    from ``flat``; tensors on ``device``, numpy leaves stay numpy."""
    def key(k) -> str:
        return f"{prefix}{SEP}{k}" if prefix else str(k)

    if isinstance(like, nn.Module):
        out = copy.deepcopy(like).to_empty(device=device)
        load_named_(out.named_parameters(), _nest(flat, prefix))
        return out
    if isinstance(like, AdamWState):
        out = AdamWState(
            step=torch.tensor(_leaf(flat, key(".step"), ()), device=device,
                              dtype=torch.int32),
            m={n: _materialise(t, device) for n, t in like.m.items()},
            v={n: _materialise(t, device) for n, t in like.v.items()})
        load_named_(out.m.items(), _nest(flat, key(".m")))
        load_named_(out.v.items(), _nest(flat, key(".v")))
        return out
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, device, key(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, device, key(i))
                          for i, v in enumerate(like))
    arr = _leaf(flat, prefix, np.shape(like))
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=device,
                                                  dtype=like.dtype)
    return arr


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save. ``state`` is a dict of state trees."""
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"tmp.{step}.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    tmp.mkdir()
    for name, tree in state.items():
        np.savez(tmp / f"{name}.npz", **_flatten(tree))
    manifest = {
        "step": int(step),
        "time": time.time(),
        "names": sorted(state),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    final = d / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := re.match(r"step_(\d+)$", p.name))]
    return max(steps) if steps else None


def _spec_checked(key: str, shape, sharding: NamedSharding) -> torch.device:
    """``sharding``'s device at coordinate (0, ..., 0), once its spec is
    known to lay out a leaf of ``shape`` on its mesh."""
    if not isinstance(sharding, NamedSharding):
        raise ValueError(f"{key}: {sharding!r} is not a NamedSharding")
    spec, mesh = tuple(sharding.spec), sharding.mesh
    if len(spec) > len(shape):
        raise ValueError(f"{key}: spec {spec} has more entries than the "
                         f"leaf's shape {tuple(shape)}")
    used = set()
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        size = 1
        for a in tup:
            if a not in mesh.axis_names:
                raise ValueError(f"{key}: spec {spec} names axis {a!r}, "
                                 f"which the mesh {mesh.axis_names} lacks")
            if a in used:
                raise ValueError(f"{key}: spec {spec} uses axis {a!r} twice")
            used.add(a)
            size *= mesh.shape[a]
        if dim % size:
            raise ValueError(f"{key}: spec {spec} splits a dimension of "
                             f"{dim} over {size} shards of the mesh "
                             f"{mesh.shape}")
    return mesh.devices.flat[0]


def _sharded_leaves(like: Any, shardings: Any, name: str):
    """(key, shape, sharding) of every leaf of the state tree ``like`` (a
    module's parameters, or an ``AdamWState``), its sharding taken from
    ``shardings`` at the same place."""
    def keyed(named, tree, at):
        if not isinstance(tree, dict) or set(tree) != {n for n, _ in named}:
            raise ValueError(f"{at}: the shardings are not keyed by the "
                             f"leaves' names")
        return [(f"{at}{SEP}{n}", t.shape, tree[n]) for n, t in named]

    if isinstance(like, nn.Module):
        return keyed(list(like.named_parameters()), shardings, name)
    if isinstance(like, AdamWState):
        if not isinstance(shardings, AdamWState):
            raise ValueError(f"{name}: an AdamWState needs an AdamWState "
                             f"of shardings")
        return ([(f"{name}{SEP}.step", like.step.shape, shardings.step)]
                + keyed(list(like.m.items()), shardings.m, f"{name}{SEP}.m")
                + keyed(list(like.v.items()), shardings.v, f"{name}{SEP}.v"))
    raise ValueError(f"{name}: shardings place a module's parameters or an "
                     f"AdamWState, not a {type(like).__name__}")


def _placement(name: str, like: Any, shardings: Any) -> torch.device:
    """The one device that a state tree goes to under ``shardings``."""
    devs = {_spec_checked(k, shape, s)
            for k, shape, s in _sharded_leaves(like, shardings, name)}
    if len(devs) != 1:
        raise ValueError(f"{name}: shardings over several meshes' first "
                         f"devices {sorted(map(str, devs))}")
    return devs.pop()


def restore(ckpt_dir: str, like: Dict[str, Any], step: Optional[int] = None,
            shardings: Optional[Dict[str, Any]] = None,
            device: Device = "cuda"
            ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """Restore state matching the ``like`` structure (new tensors on
    ``device``; ``like`` itself is left as it is, and may live on the meta
    device, as ``train.step.abstract_params`` gives).  A tree named in
    ``shardings`` goes to its shardings' device instead (the module
    docstring).  A missing leaf raises ``KeyError``, a misshapen one or a
    spec that cannot lay it out ``ValueError``."""
    shardings = shardings or {}
    placed = {name: _placement(name, tree, shardings[name])
              for name, tree in like.items() if name in shardings}
    dev = resolve_device(device) if len(placed) < len(like) else None
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = {}
    for name, tree in like.items():
        with np.load(d / f"{name}.npz") as z:
            flat = {k: z[k] for k in z.files}
        out[name] = _unflatten(tree, flat, placed.get(name, dev))
    return manifest["step"], out, manifest.get("extra", {})


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return
    steps = sorted(p for p in d.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


class CheckpointManager:
    """Async checkpointing + preemption-to-save + retention GC.  ``close``
    drains the writer, stops its thread and puts back the SIGTERM handler
    ``install_preemption_handler`` replaced."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-ckpt")
        self._worker.start()
        self._preempted = threading.Event()
        self._old_handler = None
        self.last_saved: Optional[int] = None

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, state, extra = item
                save(self.ckpt_dir, step, state, extra)
                gc_old(self.ckpt_dir, self.keep)
                self.last_saved = step
            finally:
                self._q.task_done()

    def save_async(self, step: int, state: Dict[str, Any],
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy ``state`` to the host now; write it on the writer thread."""
        host = {k: _flatten(v) for k, v in state.items()}
        self._q.put((step, host, extra))

    def save_sync(self, step: int, state: Dict[str, Any],
                  extra: Optional[Dict[str, Any]] = None) -> str:
        self.drain()
        path = save(self.ckpt_dir, step, state, extra)
        gc_old(self.ckpt_dir, self.keep)
        self.last_saved = step
        return path

    def drain(self) -> None:
        """Block until every queued async save has fully finished."""
        self._q.join()

    def close(self) -> None:
        self.drain()
        self._q.put(None)
        self._worker.join()
        if self._old_handler is not None:
            signal.signal(signal.SIGTERM, self._old_handler)
            self._old_handler = None

    # ---- preemption ----
    def install_preemption_handler(self) -> None:
        def handler(signum, frame):
            self._preempted.set()
        self._old_handler = signal.signal(signal.SIGTERM, handler)

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()
