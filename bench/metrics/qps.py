"""qps: queries answered in the window over the window's length (host
clock); the window ends at the first return after the requested seconds."""
from bench import arith, readers


def read(record):
    win = record["window"]
    return arith.window_qps(len(readers.answered(readers.window(record))),
                            win["t0"], win["t1"])
