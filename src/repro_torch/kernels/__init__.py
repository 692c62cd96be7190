"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their ctypes
bindings, their plain PyTorch versions (``ref``) and the public wrappers
(``ops``)."""
