"""phase1_roofline.batch: phase 1's work in the traced segment (each set's
images read once, one flag written per group tuple; bench/arith.py) at the
peak memory rate, as a percentage of the device time of these kernels."""
from bench import readers

KERNELS = ("bitmap_filter",)


def read(record):
    return readers.roofline(record, KERNELS, readers.phase1_work)
