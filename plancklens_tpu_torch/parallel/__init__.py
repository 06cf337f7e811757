from .mesh import make_mesh, shard_batch, shard_sht, ShardedIVFS, ShardedSHT, m_blocks
