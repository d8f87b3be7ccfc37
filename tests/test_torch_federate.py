"""The port's federation plane held to the JAX package's tests:
``tests/test_federate.py`` replayed whole through the port (the serve-protocol
client against a live view, the merged global view, the fan-in plane with its
durable tokens and staleness verdicts, the freshness and trace-joining
surfaces, codec negotiation and the federation schema)."""

from test_torch_replay import replay, replayed_tests

_REWRITES = [
    ("from k8s_watcher_tpu.config.schema import (\n    AppConfig,\n    FederationConfig,\n    SchemaError,\n",
     "from k8s_watcher_tpu_torch.config import (\n    AppConfig,\n    FederationConfig,\n"
     "    ConfigError as SchemaError,\n"),
    ("from k8s_watcher_tpu.config.schema import VALID_SERVE_CODECS",
     "from k8s_watcher_tpu_torch.config import VALID_SERVE_CODECS"),
    ("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status"),
    # the port's status server binds every interface and takes no host
    ('Liveness(900.0), host="127.0.0.1", port=0,', "Liveness(900.0), port=0,"),
]

_federate = replay("test_federate.py", rewrites=_REWRITES)
live_serve = _federate.live_serve  # the replayed client tests' fixture
globals().update(replayed_tests(_federate))
