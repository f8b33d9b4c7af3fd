"""Kernels of the port: plain versions (``ref``), CUDA launchers and the
device-dispatching wrappers (``ops``)."""
