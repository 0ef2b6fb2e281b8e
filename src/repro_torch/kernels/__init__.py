"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the backend router (``ops``)."""
