"""Serving front end of the port."""
