"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), their
ctypes wrappers, their plain PyTorch versions (``ref``) and the
device-dispatching entry points (``ops``)."""
