"""PyTorch + CUDA port of the interconnection-network simulator.

A package beside the JAX reference ``repro``: the same specs, the same
switch model and the same random stream, so its results equal the
reference's bit for bit.  The crossbar arbitration runs in hand-written
CUDA kernels for Hopper (``repro_torch.kernels``).  Entry points run on
the card; ``device="cpu"`` runs the kernels' plain PyTorch versions on
the host instead.  It imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``repro``.
"""
