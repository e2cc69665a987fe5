"""pass_device_share.batch: the device-clock length of the window's passes
(EXEC_COUNTERS ``pass_device_us``: a timing event before each pass's
first op to its ready event, so launch gaps inside a pass count) over the
window's host time, in percent."""
from bench import readers


def read(record):
    us = readers.counter(record, "pass_device_us")
    if not us:
        return None
    return 100.0 * us * 1e-6 / record["window"]["seconds"]
