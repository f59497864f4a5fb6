"""Hand-written Hopper kernels of the port, their plain versions and the
dispatch between them.  No module here imports a kernel library or runs a
compiler at import time: kernels are built at first launch."""
