"""collect_wait_share.batch: the share of the window's host time that
collects spent blocked on their passes' ready events (EXEC_COUNTERS
``collect_wait_us``, a part of ``collect_us``), in percent."""
from bench import readers


def read(record):
    us = readers.counter(record, "collect_wait_us")
    if not us:
        return None
    return 100.0 * us * 1e-6 / record["window"]["seconds"]
