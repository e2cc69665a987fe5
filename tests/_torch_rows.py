"""Seeded int32 group rows in the padding layouts the port's kernels must
handle, shared by the port's CPU tests."""
import numpy as np


def padded_rows(rng, kind, shape):
    """int32 rows of one padding layout: ``left`` fills a real prefix of
    random length and ends in -1, as ``DeviceSet`` pads its mirrors;
    ``full`` holds no -1; ``pad`` only -1; ``interior`` has -1 at random
    places and repeats values within a row."""
    if kind == "pad":
        return np.full(shape, -1, np.int32)
    x = rng.integers(0, 12 if kind == "interior" else 500,
                     size=shape).astype(np.int32)
    if kind == "left":
        real = rng.integers(0, shape[-1] + 1, size=shape[:-1] + (1,))
        x[np.arange(shape[-1]) >= real] = -1
    elif kind == "interior":
        x[rng.random(shape) < 0.3] = -1
    return x
