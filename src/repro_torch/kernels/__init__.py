"""Hand-written Hopper kernels and their wrappers (port of
``repro.kernels``).  Each kernel module holds the wrapper, the launch
counter and a plain PyTorch version of the same function; ``ops`` picks
between them by the device of the tensors it is given."""
