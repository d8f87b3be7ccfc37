"""The JAX package's ``tests/test_ingest_shards.py`` replayed through the
port: the sharded source and its batch queue, relist, per-shard resume,
``ChurnGenerator`` churn and ``JournaledMapStore``, against the port's own
mock apiserver and fault injectors."""

from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_ingest_shards.py")))
