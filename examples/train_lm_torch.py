"""Train a small LM end to end on the PyTorch port, with checkpoint/restart
fault tolerance.

The twin of ``examples/train_lm.py``: the same models, flags and claims,
through ``repro_torch``.  Default: a ~10M-param dense model, 120 steps,
trained over ``make_local_mesh()`` (every visible card, or the one
``--torch-device cpu``) through ``train(..., mesh=mesh)``, with a
simulated crash half way and a restart that resumes from the checkpoint
(bit for bit on the CPU).  ``--full`` scales to a ~100M model / 300 steps.
``--ckpt`` defaults to a directory under the system's temporary directory.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--full] [--steps N] [--torch-device cpu]
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train


def setup(args):
    """(model, mesh, data, optimizer config, loop config of the first
    half, total steps) for ``args``."""
    if args.full:
        cfg = ArchConfig(name="demo-100m", family="dense", n_layers=8,
                         d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                         vocab=32768, dtype="float32", param_dtype="float32")
        steps, batch, seq = args.steps or 300, 8, 512
    else:
        cfg = ArchConfig(name="demo-10m", family="dense", n_layers=4,
                         d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                         vocab=4096, dtype="float32", param_dtype="float32")
        steps, batch, seq = args.steps or 120, 8, 128
    model = build_model(cfg, device=args.torch_device)
    devices = ([model.device] if model.device.type == "cpu" else None)
    mesh = make_local_mesh(devices=devices)
    data = SyntheticLMData(vocab=cfg.vocab, batch=batch, seq=seq, seed=0)
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    lcfg = LoopConfig(steps=steps // 2, ckpt_dir=args.ckpt, ckpt_every=20,
                      log_every=10)
    return model, mesh, data, opt, lcfg, steps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model trains: cuda (default: every "
                         "visible card in the mesh) or cpu")
    args = ap.parse_args(argv)

    model, mesh, data, opt, lcfg, steps = setup(args)
    cfg = model.cfg
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params), "
          f"{steps} steps of {data.batch}x{data.seq} on a "
          f"{tuple(mesh.devices.shape)} mesh of {model.device.type}")

    shutil.rmtree(args.ckpt, ignore_errors=True)
    print("=== phase 1: train to half, then 'crash' ===")
    out1 = train(model, data, lcfg, opt_cfg=opt, mesh=mesh)
    print(f"phase 1 done at step {out1['final_step']}")

    print("=== phase 2: restart from checkpoint, train to the end ===")
    lcfg2 = dataclasses.replace(lcfg, steps=steps)
    out2 = train(model, data, lcfg2, opt_cfg=opt, mesh=mesh)
    first = out1["history"][0]["loss"]
    last = out2["history"][-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved ✓' if last < first else 'NO IMPROVEMENT ✗'})")
    print(f"stragglers observed: {out1['stragglers'] + out2['stragglers']}")
    return {"first": out1, "second": out2, "improved": last < first}


if __name__ == "__main__":
    main()
