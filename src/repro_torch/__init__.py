"""PyTorch/CUDA port of the EPARA serving system.

The JAX + Pallas package ``repro`` is the reference; this package is held
against it on the same weights and inputs.  It imports ``torch`` and never
``jax`` or ``repro``.  Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``).
"""
