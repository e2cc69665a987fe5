"""host_plan_share.batch: the share of the window's host time spent in
host-routed plans, HashBin here (EXEC_COUNTERS ``host_plan_us``, timed in
``SearchEngine._execute_host_plan``), in percent."""
from bench import readers


def read(record):
    us = readers.counter(record, "host_plan_us")
    if not us:
        return None
    return 100.0 * us * 1e-6 / record["window"]["seconds"]
