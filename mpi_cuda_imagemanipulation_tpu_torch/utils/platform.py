"""What a device is: the one definition of "a real card" that every
calibrated decision consults, and the device kind its records are keyed
by. The counterpart of the JAX package's ``utils/platform.py``.

`is_cuda_device` stands for the JAX package's ``is_tpu_backend``: a
calibration record or an ``MCIM_PREFER_*`` switch may promote a route
only on a CUDA device, so the CPU (the tests, ``--device cpu``) always
takes the default routes. `device_kind` keys the calibration store
(utils/calibration.py): ``torch.cuda.get_device_name`` on a card, such
as ``"NVIDIA H100 80GB HBM3"``, else ``"cpu"``, so a record taken on one
kind of card never steers another, nor a TPU record the card.

The JAX package's ``claim_platform`` and ``_backends_initialized`` guard
its JAX backend selection and have no counterpart: a PyTorch caller names
its device.
"""

from __future__ import annotations

import torch


def is_cuda_device(device) -> bool:
    """Whether `device` (a torch.device or its name; None = the default
    CUDA device) is a CUDA card this process can use."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def device_kind(device) -> str:
    """The calibration store's key for `device`: the card's name, or
    'cpu'."""
    if not is_cuda_device(device):
        return "cpu"
    dev = torch.device("cuda" if device is None else device)
    return torch.cuda.get_device_name(
        dev.index if dev.index is not None else torch.cuda.current_device()
    )
