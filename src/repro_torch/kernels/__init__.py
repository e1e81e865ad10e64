"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Sources live in ``csrc/``; :mod:`._build` compiles them with ``nvcc`` at
first use and loads them with ``ctypes``.  Nothing is compiled at import.
"""
