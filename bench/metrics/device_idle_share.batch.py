"""device_idle_share.batch: 1 minus the union of kernel, copy and memset
intervals over the traced segment's length (torch.profiler), in percent."""
from bench import readers


def read(record):
    return readers.idle_percent(record)
