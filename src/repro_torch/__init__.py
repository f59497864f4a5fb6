"""PyTorch/CUDA port of the FedPairing system.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  Its entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
