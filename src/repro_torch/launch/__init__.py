"""Meshes the port serves over (``make_production_mesh``, ``make_local_mesh``)."""
