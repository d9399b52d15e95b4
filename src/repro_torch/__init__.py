"""PyTorch / CUDA port of the Spritz packet engine (see README.md).

Mirrors the layout of ``repro``, which stays the reference.  Imports
torch and numpy only, never jax nor ``repro``.
"""
