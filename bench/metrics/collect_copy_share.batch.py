"""collect_copy_share.batch: the share of the window's host time that
collects spent copying their passes' outputs to host numpy arrays, after
the wait (EXEC_COUNTERS ``collect_copy_us``, a part of ``collect_us``), in
percent."""
from bench import readers


def read(record):
    us = readers.counter(record, "collect_copy_us")
    if not us:
        return None
    return 100.0 * us * 1e-6 / record["window"]["seconds"]
