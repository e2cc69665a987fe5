"""Training loop with checkpoint/restart, preemption and straggler guards.

The port's copy of the JAX package's ``train/loop.py``, on one device or
over a mesh (``mesh=``: the step is built over it, ``train/step.py``).
The loop is deliberately boring: all cleverness lives in the step function
(train/step.py) and the checkpoint manager.  Fault tolerance properties:

  * deterministic resume — data is index-addressable (data/pipeline.py);
    the only pipeline state is the step counter in the manifest; a resumed
    run gives the straight run's losses bit for bit on the CPU;
  * SIGTERM (preemption) triggers a synchronous save then a clean exit;
  * per-step deadline monitor: a step exceeding ``straggler_factor`` x the
    trailing-median step time increments a counter and logs;
  * periodic async checkpoints overlap serialization with compute.

Checkpoints are the JAX package's layout (``train/checkpoint.py``), so a
run may resume from the other package's.  A fresh run draws its weights
with the port's ``model.init`` from ``seed`` (the JAX package's
distributions, not its draws).  The arguments keep the port's order,
``train(model, data, loop_cfg, ..., mesh=None)``, where JAX's is
``train(model, mesh, data, loop_cfg, ...)``: one device needs no mesh.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.model import Model
from ..optim import adamw
from . import checkpoint as ckpt
from .step import abstract_params, build_train_step


@dataclasses.dataclass
class LoopConfig:
    """The JAX package's ``LoopConfig``, except that ``ckpt_dir`` has no
    default (JAX's is one fixed path, where two runs that keep it would
    resume each other's checkpoints): it is given by keyword."""
    steps: int = 100
    ckpt_dir: str = dataclasses.field(kw_only=True)
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3
    resume: bool = True
    straggler_factor: float = 3.0
    seed: int = 0


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``: integer arrays as int64 (index
    tensors), float arrays as they are."""
    return {k: torch.from_numpy(np.asarray(
        v, dtype=np.int64 if np.issubdtype(v.dtype, np.integer) else None)
    ).to(device) for k, v in batch.items()}


def train(model: Model, data, loop_cfg: LoopConfig,
          opt_cfg: Optional[adamw.AdamWConfig] = None,
          microbatch: int = 1,
          log_fn: Callable[[str], None] = print,
          mesh=None) -> Dict[str, Any]:
    """Train ``model`` on ``data.batch_at(step)`` from the latest
    checkpoint in ``loop_cfg.ckpt_dir`` (or from ``model.init``) to
    ``loop_cfg.steps``.  Returns the history ({"step", "loss", "time_s"}
    a step), the final step, the straggler count, params and opt state.
    With ``mesh``, every step runs over it (``build_train_step``)."""
    step_fn, _, opt_cfg = build_train_step(model, mesh, opt_cfg=opt_cfg,
                                           microbatch=microbatch)
    dev = model.device
    mgr = ckpt.CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
    mgr.install_preemption_handler()
    try:
        start_step = 0
        if loop_cfg.resume and ckpt.latest_step(loop_cfg.ckpt_dir) is not None:
            p_abs = abstract_params(model)
            o_abs = adamw.init(opt_cfg, p_abs)
            start_step, restored, _ = ckpt.restore(
                loop_cfg.ckpt_dir, {"params": p_abs, "opt": o_abs},
                device=dev)
            params, opt_state = restored["params"], restored["opt"]
            log_fn(f"[resume] restored step {start_step} from "
                   f"{loop_cfg.ckpt_dir}")
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(loop_cfg.seed)
            params = model.init(gen)
            opt_state = adamw.init(opt_cfg, params)

        history: List[Dict[str, float]] = []
        times: List[float] = []
        stragglers = 0
        final_step = start_step
        for step in range(start_step, loop_cfg.steps):
            batch = to_device(data.batch_at(step), dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = metrics["loss"].item()  # blocks; acts as the step barrier
            dt = time.perf_counter() - t0
            times.append(dt)
            if len(times) >= 5:
                med = statistics.median(times[-20:])
                if dt > loop_cfg.straggler_factor * med:
                    stragglers += 1
                    log_fn(f"[straggler] step {step} took {dt:.3f}s "
                           f"(median {med:.3f}s) — would trigger host swap")
            if step % loop_cfg.log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            history.append({"step": step, "loss": loss, "time_s": dt})
            final_step = step + 1
            if (step + 1) % loop_cfg.ckpt_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt_state},
                               extra={"data_step": step + 1})
            if mgr.preempted:
                log_fn(f"[preempt] SIGTERM at step {step}; saving and exiting")
                mgr.save_sync(step + 1, {"params": params, "opt": opt_state},
                              extra={"data_step": step + 1, "preempted": True})
                break
        else:
            mgr.save_sync(final_step, {"params": params, "opt": opt_state},
                          extra={"data_step": final_step})
    finally:
        mgr.close()

    return {
        "history": history,
        "final_step": final_step,
        "stragglers": stragglers,
        "params": params,
        "opt_state": opt_state,
    }
