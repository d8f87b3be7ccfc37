"""The port's relay tier held to the JAX package's tests:
``tests/test_relay.py`` replayed whole through the port (the raw-bytes
passthrough with zero re-encodes, the sparse relay journal, mid-life
re-adopts surfacing as GONE, backfill across a restart, depth stamping,
codec pinning and the relay schema)."""

from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_relay.py", rewrites=[
    ("from k8s_watcher_tpu.config.schema import (\n    AppConfig,\n    RelayConfig,\n    SchemaError,\n",
     "from k8s_watcher_tpu_torch.config import (\n    AppConfig,\n    RelayConfig,\n"
     "    ConfigError as SchemaError,\n"),
    ("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status"),
])))
