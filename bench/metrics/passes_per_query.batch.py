"""passes_per_query.batch: device passes (first passes and overflow
re-runs, EXEC_COUNTERS ``batch_calls``) in the window over the window's
device-routed queries."""
from bench import readers


def read(record):
    queries = len(readers.device_routed(readers.window(record)))
    if not queries:
        return None
    return readers.counter(record, "batch_calls") / queries
