"""PyTorch / CUDA port of :mod:`repro`, held to the JAX package by parity tests.

The port mirrors ``repro``'s module paths where that helps a reader find the
counterpart (``repro.models.dense`` -> ``repro_torch.models.dense``).  It never
imports ``jax`` or anything under ``repro.``.  Every entry point runs on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; attention
runs through hand-written CUDA kernels on the card and through their plain
PyTorch versions on the CPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
