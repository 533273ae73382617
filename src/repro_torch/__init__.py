"""repro_torch: the PyTorch / CUDA port of the GreenLLM reproduction for one
NVIDIA H100.  It mirrors the layout and names of the JAX package ``repro``
(the reference, which it never imports) and runs its kernels as CUDA C++
written for Hopper (``kernels/csrc``)."""
