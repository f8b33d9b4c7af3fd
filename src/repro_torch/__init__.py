"""PyTorch/CUDA port of the decentralized Riemannian minimax system.

A second package beside the JAX reference ``repro``: the same module layout
and names, PyTorch inside, and a hand-written CUDA kernel (``kernels/csrc``)
for every TPU kernel on the ported path.  It imports neither JAX nor
anything of ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
