"""The package's default device.

Tensors a caller passes keep their device. Python numbers, lists and NumPy
arrays become tensors on the default device, which is ``"cuda"``: the
entry points run on the card unless the caller asks for the CPU, with
``set_default_device("cpu")`` or a CPU tensor. Nothing falls back to the
CPU: without a GPU, making such a tensor raises CUDA's own error.
"""

from __future__ import annotations

import torch

__all__ = ["set_default_device", "default_device", "as_tensor"]

_DEFAULT = torch.device("cuda")


def set_default_device(device) -> None:
    """Set the device that non-tensor input goes to (``"cuda"`` or ``"cpu"``)."""
    global _DEFAULT
    _DEFAULT = torch.device(device)


def default_device() -> torch.device:
    return _DEFAULT


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor`` that keeps a tensor's device and puts anything
    else on `device`, else the default device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=_DEFAULT if device is None else device)
