"""collect_filter_share.batch: the share of the window's host time that
collects spent in their loop over rows on the host: dropping the -1
padding, the sort, the stats (EXEC_COUNTERS ``collect_filter_us``, a part
of ``collect_us``), in percent."""
from bench import readers


def read(record):
    us = readers.counter(record, "collect_filter_us")
    if not us:
        return None
    return 100.0 * us * 1e-6 / record["window"]["seconds"]
