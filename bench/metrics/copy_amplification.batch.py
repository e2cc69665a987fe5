"""copy_amplification.batch: bytes the window's collects copied to the
host (EXEC_COUNTERS ``d2h_bytes``, first passes and re-runs) over 4 bytes
times the ids that the window's device-routed queries answered: how many
times over the answer the collect copies."""
from bench import readers


def read(record):
    copied = readers.counter(record, "d2h_bytes")
    ids = sum(len(r["result"].doc_ids)
              for r in readers.device_routed(readers.window(record)))
    if not copied or not ids:
        return None
    return copied / (4.0 * ids)
