"""index_build_s: the host preprocessing of every list inside
SearchEngine.__init__, as the engine times it (``build_s``)."""


def read(record):
    return record["build_s"]
