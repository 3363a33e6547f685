"""repro_torch: the PyTorch / CUDA port of ``repro`` — bit-serial median
clustering for memory management and request processing, served on one
NVIDIA H100.

The package mirrors ``repro``'s module paths and function names so each
function has an obvious counterpart; it imports ``torch``, numpy and the
standard library only.  Kernels written by hand for Hopper live under
``csrc/`` and are built with ``nvcc`` at first use (``kernels/_build.py``).
"""
