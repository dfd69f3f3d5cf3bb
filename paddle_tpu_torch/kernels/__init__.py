"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Importing this package builds nothing: the kernel library is compiled by
``kernels.build`` at the first launch on a CUDA tensor.
"""
