"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version (``ref``) and behind a dispatcher (``ops``)."""
