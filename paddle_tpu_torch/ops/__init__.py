"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.
Kernels build on first use (``ops/_build.py``); importing this package
needs neither ``nvcc`` nor a GPU."""
