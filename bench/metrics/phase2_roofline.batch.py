"""phase2_roofline.batch: phase 2's work in the traced segment (the real
elements of every survivor's groups read once, one kept flag written per
base element; bench/arith.py) at the peak memory rate, as a percentage of
the device time of these kernels."""
from bench import readers

KERNELS = ("group_match",)


def read(record):
    return readers.roofline(record, KERNELS, readers.phase2_work)
