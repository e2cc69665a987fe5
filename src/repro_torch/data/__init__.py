"""Synthetic corpora for the tests and the chip smoke run."""
