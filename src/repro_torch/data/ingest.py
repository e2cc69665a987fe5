"""Streaming binary ingestion for the suggestion corpus.

The suggestion service (:class:`repro_torch.serve.search.SuggestEngine`)
grows its corpus one set at a time: sets arrive from logs, crawls or a feed,
not as one in-memory dict.  This module holds the length-prefixed
little-endian record format and a chunk-tolerant streaming reader, so a
corpus can be replayed from disk (or any byte iterator) into a live engine:

    file   := MAGIC (4 bytes, b"RSI1") record*
    record := set_id:uint32  n:uint32  values:uint32[n]

Everything is little-endian uint32.  The reader takes byte chunks of any
size (:func:`stream_records`): a record split across a chunk boundary is
buffered and completed by the next chunk.  A truncated tail raises
``ValueError`` rather than dropping data.  Duplicate ``set_id`` records are
replacements, last writer wins, as :meth:`SuggestEngine.add_set` does.

The format and its byte layout are those of the JAX package's
``repro.data.ingest``, so a file written by either package reads in the
other.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np

__all__ = [
    "MAGIC", "write_records", "read_records", "stream_records",
    "ingest_file",
]

MAGIC = b"RSI1"
_U32 = np.dtype("<u4")


def write_records(path_or_stream,
                  records: Iterable[Tuple[int, Sequence[int]]]) -> int:
    """Serialize ``(set_id, values)`` pairs; returns the record count.

    Takes a filesystem path or any binary stream with ``write``.  Values
    are cast to uint32; their order inside a record is kept as it is.
    """
    own = not hasattr(path_or_stream, "write")
    stream = open(path_or_stream, "wb") if own else path_or_stream
    n_records = 0
    try:
        stream.write(MAGIC)
        for set_id, values in records:
            vals = np.asarray(values, _U32)
            stream.write(np.asarray([set_id, vals.size], _U32).tobytes())
            stream.write(vals.tobytes())
            n_records += 1
    finally:
        if own:
            stream.close()
    return n_records


def stream_records(chunks: Iterable[bytes]
                   ) -> Iterator[Tuple[int, np.ndarray]]:
    """Decode records from byte chunks of any size, yielding ``(set_id,
    values)`` as soon as each record is complete; only the unfinished tail
    is held between chunks.  Raises ``ValueError`` on a bad magic or a
    truncated final record."""
    buf = b""
    seen_magic = False
    for chunk in chunks:
        buf += bytes(chunk)
        if not seen_magic:
            if len(buf) < len(MAGIC):
                continue
            if buf[:len(MAGIC)] != MAGIC:
                raise ValueError(
                    f"bad magic {buf[:len(MAGIC)]!r}; expected {MAGIC!r}")
            buf = buf[len(MAGIC):]
            seen_magic = True
        while len(buf) >= 8:
            set_id, n = np.frombuffer(buf, _U32, count=2)
            end = 8 + 4 * int(n)
            if len(buf) < end:
                break  # the record straddles the chunk boundary
            yield int(set_id), np.frombuffer(buf, _U32, count=int(n),
                                             offset=8).copy()
            buf = buf[end:]
    if not seen_magic and buf:
        raise ValueError(f"bad magic {buf[:len(MAGIC)]!r}; expected {MAGIC!r}")
    if buf:
        raise ValueError(f"truncated record: {len(buf)} trailing bytes")


def read_records(path, chunk_size: int = 1 << 16
                 ) -> Iterator[Tuple[int, np.ndarray]]:
    """Stream records from a file path in ``chunk_size``-byte reads."""
    with open(path, "rb") as f:
        yield from stream_records(iter(lambda: f.read(chunk_size), b""))


def ingest_file(path, engine, chunk_size: int = 1 << 16) -> int:
    """Fold a record file into a live suggestion engine, one set at a time
    (each record is served before the next is decoded).

    ``engine`` is anything with ``add_set(set_id, values)``.  Returns the
    number of records applied; empty records are skipped (an empty set is
    never a suggestion, and preprocessing needs n >= 1).
    """
    n_applied = 0
    for set_id, values in read_records(path, chunk_size=chunk_size):
        if values.size:
            engine.add_set(set_id, values)
            n_applied += 1
    return n_applied
