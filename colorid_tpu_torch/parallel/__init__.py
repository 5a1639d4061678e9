"""Sharded query execution on a single-process logical mesh
(``sharded.py``: the mesh and the per-shard bodies; ``engine.py``:
``ShardedQueryEngine``)."""
