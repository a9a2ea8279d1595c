"""numpy / torch dispatch helper."""

import numpy as np
import torch


class _TorchNumpy:
    """The numpy names ``invert_uv_core`` uses, on torch tensors (torch
    spells several of them differently)."""

    @staticmethod
    def flip(x, axis):
        return torch.flip(x, dims=(axis,))

    arctan2 = staticmethod(torch.atan2)
    degrees = staticmethod(torch.rad2deg)
    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)
    hypot = staticmethod(torch.hypot)


torch_numpy = _TorchNumpy()


def array_module(*arrays):
    """``torch_numpy`` if any input is a torch tensor, else ``numpy``.
    Lets one implementation serve the host data plane (numpy) and the
    device-side output pack (torch)."""
    if any(isinstance(a, torch.Tensor) for a in arrays):
        return torch_numpy
    return np
