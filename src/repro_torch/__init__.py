"""PyTorch/CUDA port of the energy-aware fault-tolerance engine.

Mirrors the layout and public names of the JAX package ``repro`` (the
reference) one slice at a time; see ROADMAP.md for what is ported.  The
package imports ``torch`` and ``numpy`` only.  Every public entry point
takes ``device=`` and defaults to ``"cuda"``: the CPU runs only when the
caller asks for it (``device="cpu"``), and a CUDA request on a machine
without a card raises instead of falling back.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
