"""LM training: the train step on one device or over a mesh, checkpoints,
the loop and elastic restarts."""
