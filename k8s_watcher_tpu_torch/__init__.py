"""PyTorch and CUDA port of the k8s-watcher-tpu probe plane."""
