"""PyTorch/CUDA port of the EASEY serving stack (``src/repro`` is the JAX
reference it is checked against).

The package mirrors ``repro`` module for module.  It imports ``torch``
and never ``jax`` or ``repro``; hand-written CUDA kernels for Hopper
(``kernels/csrc``) take the place of the reference's Pallas kernels.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
