"""`device_type` -> torch device, shared by training, device binning and
prediction."""

from __future__ import annotations

import torch


def resolve_device(device_type: str) -> torch.device:
    """`device_type` -> torch device.  The port runs on the card unless
    the caller asks for the CPU; it never falls back silently."""
    dt = str(device_type).strip().lower()
    if dt in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device_type={device_type!r} needs a CUDA device and torch "
                "sees none; pass device_type='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if dt == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device_type={device_type!r}: the PyTorch port runs "
                     "on 'cuda' (default) or 'cpu'")
