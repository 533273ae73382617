"""The port's kernels: each module holds a wrapper that launches a
hand-written CUDA kernel for CUDA tensors, the plain PyTorch version it is
held against (taken for CPU tensors), and a ``launches`` count."""
