"""Device-memory sampling for the training telemetry (PyTorch port of the
sampler half of `lightgbm_tpu/observability/watchdog.py`).

`sample_device_memory` reads `torch.cuda.memory_stats()` of the booster's
device into the JAX package's gauge names (live, peak and total bytes;
reserved bytes besides), and `update_memory_gauges` writes them into the
metrics registry, so the per-iteration event log carries device-memory
occupancy.  On the CPU it returns an empty dict, as the JAX sampler does
on its CPU backend.  The JAX module's `RecompileDetector` fingerprints
jitted calls: eager torch has no recompiles to detect, so it has no
counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .registry import global_registry


def sample_device_memory(device: Optional[torch.device] = None
                         ) -> Dict[str, int]:
    """Live/peak/limit bytes of `device` (the current CUDA device when
    None), or {} on the CPU or before CUDA is initialized."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        dev = torch.device(device) if device is not None \
            else torch.device("cuda", torch.cuda.current_device())
        stats = torch.cuda.memory_stats(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
    except Exception:  # noqa: BLE001 - a telemetry probe must never raise
        return {}
    out: Dict[str, int] = {}
    for src, dst in (("allocated_bytes.all.current", "device_bytes_in_use"),
                     ("allocated_bytes.all.peak", "device_peak_bytes_in_use"),
                     ("reserved_bytes.all.current", "device_bytes_reserved")):
        if src in stats:
            out[dst] = int(stats[src])
    out["device_bytes_limit"] = int(total)
    return out


def update_memory_gauges(device: Optional[torch.device] = None
                         ) -> Dict[str, int]:
    """Sample device memory into the global registry (the engine calls
    this on every nonfinite_check_freq tick)."""
    stats = sample_device_memory(device)
    for k, v in stats.items():
        global_registry.set_gauge(k, v)
    return stats
