"""Device-memory observability: live and peak allocator gauges per card.
The counterpart of the JAX package's ``obs/devmem.py``.

A serving process cannot run blind on device memory: a compile grid
growing past its budget, a leaked staged buffer or an oversized request
shows up first as shrinking headroom, and only later as an out-of-memory
error mid-dispatch. This module turns PyTorch's caching-allocator counters
(``torch.cuda.memory_stats``) and the card's free/total figures
(``torch.cuda.mem_get_info``) into callback gauges on the serving
registry, so every scrape carries the current picture:

    mcim_devmem_bytes_in_use{device}       live allocated bytes
    mcim_devmem_peak_bytes_in_use{device}  high-water mark of the above
    mcim_devmem_bytes_limit{device}        the card's memory
    mcim_devmem_headroom_frac{device}      (limit - in_use) / limit

The keys follow the JAX package's (PJRT's ``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``; absent keys read 0), with
``bytes_reserved`` (the allocator's cached segments) and ``bytes_free``
(the card's free memory) beside them. Without CUDA there is no device to
report: the gauges render empty, as the JAX package's do on a backend
without stats. Tests inject a `stats_fn` returning the same mapping. A
reader that fails reports nothing rather than raising into a scrape.
"""

from __future__ import annotations

import torch

from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry


def device_memory_stats() -> dict[str, dict]:
    """``{"cuda:<i>": stats}`` for every visible CUDA device; {} without
    CUDA, and a device whose counters cannot be read is left out."""
    out: dict[str, dict] = {}
    try:
        if not torch.cuda.is_available():
            return out
        n = torch.cuda.device_count()
    except Exception:
        return out
    for i in range(n):
        try:
            s = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
        except Exception:
            continue
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "bytes_free": int(free),
        }
    return out


class DevMemGauges:
    """The gauge families over one stats source. Construct once per app
    registry (ServeApp does); `stats_fn` defaults to the live allocator and
    is injectable for CPU tests."""

    def __init__(self, registry: Registry, stats_fn=None):
        self.registry = registry
        self._stats_fn = stats_fn or device_memory_stats

        def field(name: str):
            def read() -> dict:
                return {
                    (dev,): float(stats.get(name, 0) or 0)
                    for dev, stats in self._stats().items()
                }

            return read

        self.in_use = registry.gauge(
            "mcim_devmem_bytes_in_use",
            "Live allocated bytes per device (torch.cuda.memory_stats).",
            labels=("device",),
            fn=field("bytes_in_use"),
        )
        self.peak = registry.gauge(
            "mcim_devmem_peak_bytes_in_use",
            "Peak allocated bytes per device since the process started "
            "(or the allocator's peak was last reset).",
            labels=("device",),
            fn=field("peak_bytes_in_use"),
        )
        self.limit = registry.gauge(
            "mcim_devmem_bytes_limit",
            "Device memory per device (torch.cuda.mem_get_info).",
            labels=("device",),
            fn=field("bytes_limit"),
        )
        self.headroom = registry.gauge(
            "mcim_devmem_headroom_frac",
            "Fraction of the device's memory not allocated by this process "
            "per device: the distance to an out-of-memory error.",
            labels=("device",),
            fn=self._headroom,
        )
        self.devices = registry.gauge(
            "mcim_devmem_devices",
            "Devices reporting allocator stats (0 without CUDA).",
            fn=lambda: float(len(self._stats())),
        )

    def _stats(self) -> dict:
        try:
            return self._stats_fn() or {}
        except Exception:
            return {}

    def _headroom(self) -> dict:
        out = {}
        for dev, stats in self._stats().items():
            limit = float(stats.get("bytes_limit", 0) or 0)
            if limit <= 0:
                continue
            in_use = float(stats.get("bytes_in_use", 0) or 0)
            out[(dev,)] = max(0.0, (limit - in_use) / limit)
        return out

    def snapshot(self) -> dict:
        """The /stats section: the raw per-device numbers plus headroom."""
        return {
            dev: {
                "bytes_in_use": s.get("bytes_in_use", 0),
                "peak_bytes_in_use": s.get("peak_bytes_in_use", 0),
                "bytes_limit": s.get("bytes_limit", 0),
                "headroom_frac": (
                    (s["bytes_limit"] - s.get("bytes_in_use", 0)) / s["bytes_limit"]
                    if s.get("bytes_limit")
                    else None
                ),
            }
            for dev, s in self._stats().items()
        }
