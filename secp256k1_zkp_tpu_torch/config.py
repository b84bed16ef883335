"""Configuration of the port.

Counterpart of the JAX package's ``config.py``, cut to what the ported
slice uses: the device of an entry point.  There is deliberately no
kernel-dispatch switch: the device of the input tensors decides, and a
CUDA tensor either goes through the hand-written kernel or raises.
"""

from __future__ import annotations


def resolve_device(device):
    """``device`` argument of an entry point -> ``torch.device``.

    Entry points default to ``"cuda"``; asking for it on a machine with no
    card raises instead of quietly running on the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (or CPU tensors) to run the plain "
            "PyTorch versions")
    return dev
