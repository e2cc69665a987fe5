"""Core data structures and the device engine of the port."""
