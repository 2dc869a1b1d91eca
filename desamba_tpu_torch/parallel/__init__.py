"""The genome-sharded index: the host engine that classifies against every
shard and merges the candidates (shard_index). The device classifier over
the same shards is engine/sharded_fast.py."""
