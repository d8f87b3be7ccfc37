"""``python -m k8s_watcher_tpu_torch [environment] [--cpu]``: the watcher."""

import sys

from k8s_watcher_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
