"""repro_torch — the sketching system in PyTorch, with CUDA kernels for Hopper.

A second implementation of ``repro`` (the JAX reference): the same modules and
public names, the same random streams bit for bit, and hand-written CUDA
kernels in place of the reference's Pallas kernels. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
