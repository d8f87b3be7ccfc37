"""The benchmark of ``k8s_watcher_tpu_torch``, the PyTorch and CUDA port.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout on a machine with an NVIDIA GPU. Everything it
measures is found by name: the cell in ``BENCHMARK.json``, its deployment in
``configs/<config>.json``, its traffic and driver in ``workloads/<cell>.json``,
the driver in ``drivers/<driver>.py``, and each per-layer metric's reader in
``metrics/<metric>.py``. It imports neither JAX nor the JAX package.
"""
