"""setup_s: process start to the first timed request (host clock): data,
the engine's index build and mirrors, the kernel library, the warm call."""


def read(record):
    return record["setup_s"]
