"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper.

The JAX package (``src/repro``) is the reference; this package mirrors its
layout (``configs``, ``core``, ``kernels``, ``models``, ``serving``,
``launch``) and imports nothing from it, nor JAX.  Kernels that the JAX
package wrote in Pallas for the TPU are hand-written CUDA C++ here
(``csrc/``), built with ``nvcc`` at first use.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
