"""The JAX package's ``tests/test_properties.py`` replayed through the port:
the hypothesis properties over the config merge, the mock cluster's paging,
the link classifier, the trend tracker, slices, phases and the journaled
checkpoint, each now drawing its examples against the port's modules."""

from test_torch_replay import replay, replayed_tests

globals().update(replayed_tests(replay("test_properties.py", rewrites=[
    ("from k8s_watcher_tpu.config.loader import deep_merge, substitute_env_vars",
     "from k8s_watcher_tpu.config import deep_merge, substitute_env_vars"),
])))
