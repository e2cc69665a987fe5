"""Batched multi-query execution: :mod:`plan` normalizes raw queries into
shape-keyed plans, :mod:`batch` groups plans by signature and runs one pass
per bucket through ``core.engine``, :mod:`cache` remembers the results of
repeated normalized plans."""
