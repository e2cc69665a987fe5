"""collect_share.batch: the share of the window's host time spent in the
blocking collect (EXEC_COUNTERS ``collect_us``), in percent."""
from bench import readers


def read(record):
    us = readers.counter(record, "collect_us")
    if not us:
        return None
    return 100.0 * us * 1e-6 / record["window"]["seconds"]
