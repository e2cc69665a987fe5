"""Constrained decoding on the PyTorch port: the paper's word-representation
intersection at vocabulary scale.  k constraint bitmaps (grammar
whitelist, stop-list, retrieval-derived allowed set) are ANDed per decode
step (Algorithm 2 line 1) and gate the logits of a small LM served with
batched requests.

The twin of ``examples/constrained_decode.py``: the same model shape,
constraint sets, requests and claims, through ``repro_torch``, with the
port's own weights drawn from seed 0 (so the generated tokens are not the
JAX script's).  Runs on ``--torch-device`` (default ``cuda``; ``cpu``).

Run:  PYTHONPATH=src python examples/constrained_decode_torch.py [--torch-device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import build_model
from repro_torch.serve.constrain import ConstraintSet
from repro_torch.serve.engine import DecodeServer, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model and the masks live: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)

    cfg = ArchConfig(name="demo-tiny", family="dense", n_layers=2,
                     d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                     vocab=512, dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=args.torch_device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)

    rng = np.random.default_rng(0)
    cs = ConstraintSet(cfg.vocab, device=model.device)
    grammar = rng.choice(cfg.vocab, 200, replace=False)
    whitelist = rng.choice(cfg.vocab, 300, replace=False)
    cs.add_allowed("grammar", grammar)
    cs.add_allowed("retrieval", whitelist)
    cs.add_banned("stoplist", np.arange(10))
    packed = cs.combined()  # bitmap AND across all three constraint sets

    allowed = set(np.intersect1d(grammar, whitelist)) - set(range(10))
    print(f"constraint sets: grammar=200 ∧ retrieval=300 ∧ ¬stop=10 "
          f"-> {len(allowed)} allowed tokens")

    server = DecodeServer(model, params, batch_slots=2, max_seq=64)
    reqs = [Request(prompt=np.array([1, 2, 3]), max_new=8, constraint=packed),
            Request(prompt=np.array([4, 5]), max_new=8, constraint=packed),
            Request(prompt=np.array([7, 8, 9]), max_new=8)]  # unconstrained
    for r in reqs:
        server.submit(r)
    server.run_until_drained()

    for i, r in enumerate(reqs):
        ok = all(t in allowed for t in r.out) if r.constraint is not None else True
        tag = "constrained" if r.constraint is not None else "free       "
        print(f"req{i} [{tag}] out={r.out} "
              f"{'✓ all tokens in the intersection' if ok else '✗ VIOLATION'}")
        if r.constraint is not None:
            assert ok, "constraint violated!"
    print("constrained decoding respected the bitmap intersection ✓")
    return {"allowed": allowed, "requests": reqs}


if __name__ == "__main__":
    main()
