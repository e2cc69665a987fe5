"""Sharding rules, the activation-mesh context and the collectives that the
sharded LM paths run between their per-shard stages."""
