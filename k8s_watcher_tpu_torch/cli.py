"""The watcher's command line (the JAX package's ``cli.py``).

Usage: ``python -m k8s_watcher_tpu_torch [environment] [--cpu]``

The environment is the argument, else ``ENVIRONMENT``, else ``development``;
its settings come from ``config/`` relative to the working directory. With
``tpu.probe.enabled`` the in-process probe agent runs on this rank's GPU, and
the watcher refuses to start without one; ``--cpu`` runs it on the CPU
instead. SIGINT and SIGTERM stop the watcher gracefully (the watch read is
cut, the notification backlog drained, the checkpoint flushed) and the
command exits 0; any start-up error exits 1.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
from typing import Optional, Sequence

from k8s_watcher_tpu_torch.config import ConfigError, load_app_config, resolve_environment
from k8s_watcher_tpu_torch.logging_setup import setup_logging

logger = logging.getLogger(__name__)


def install_signal_handlers(app) -> bool:
    """Route SIGTERM/SIGINT to ``app.stop()``; False off the main thread
    (``signal.signal`` is main-thread only: embedding callers handle
    signals themselves)."""

    def _handle(signum, frame):
        logger.info("Received %s; shutting down gracefully", signal.Signals(signum).name)
        app.stop()

    if threading.current_thread() is not threading.main_thread():
        return False
    signal.signal(signal.SIGTERM, _handle)
    signal.signal(signal.SIGINT, _handle)
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = [a for a in argv if not a.startswith("--")]
    unknown = sorted({a for a in argv if a.startswith("--")} - {"--cpu"})
    if unknown:
        print(f"unknown option(s): {' '.join(unknown)}", file=sys.stderr)
        return 2
    on_cpu = "--cpu" in argv
    try:
        environment = resolve_environment(args[:1])
    except ConfigError as exc:
        print(f"Error: {exc}")
        return 1

    print(f"Starting k8s-watcher-tpu (PyTorch) in '{environment}' environment")
    try:
        config = load_app_config(environment)
        setup_logging(environment, config.watcher.log_level)
        from k8s_watcher_tpu_torch.app import WatcherApp

        app = WatcherApp(
            config,
            device="cpu" if on_cpu else None,
            # an explicit --cpu run is held to the CPU; by default, to CUDA
            expected_platform="cpu" if on_cpu else "auto",
        )
        install_signal_handlers(app)
        app.run()
    except KeyboardInterrupt:
        return 0
    except Exception as exc:
        print(f"Error starting watcher: {exc}")
        return 1
    return 0
