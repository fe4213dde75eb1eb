"""Host and device memory probes (port of the JAX package's
``utils/memprofile.py``).

Reference: ``MemProfile::get{Peak,Current}RSS`` (include/misc/MemProfile.hpp:
33-52, src/misc/memProfile.cpp), plus the card's memory from
``torch.cuda.memory_stats`` under the key names JAX's ``memory_stats`` uses.
"""

from __future__ import annotations

import resource

import torch


def _status(key: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key):
                return int(line.split()[1]) * 1024
    return 0


def current_rss() -> int:
    """Current resident set size in bytes (Linux /proc)."""
    return _status("VmRSS:")


def peak_rss() -> int:
    """Peak resident set size in bytes (Linux /proc; ``getrusage`` where
    /proc has no VmHWM)."""
    return (_status("VmHWM:")
            or resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)


# JAX's memory_stats keys -> torch.cuda.memory_stats keys
_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
}


def device_memory(device=None) -> dict:
    """The caching allocator's memory of one device (default the current
    card): ``{bytes_in_use, peak_bytes_in_use, bytes_reserved,
    peak_bytes_reserved, num_allocs, bytes_limit}``; {} for a CPU device."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {k: int(stats.get(v, 0)) for k, v in _KEYS.items()}
    out["bytes_limit"] = torch.cuda.get_device_properties(device).total_memory
    return out


def report() -> str:
    lines = [f"host RSS: {current_rss() / 2**20:.1f} MiB "
             f"(peak {peak_rss() / 2**20:.1f} MiB)"]
    for i in range(torch.cuda.device_count()):
        st = device_memory(torch.device("cuda", i))
        lines.append(
            f"cuda:{i}: {st['bytes_in_use'] / 2**20:.1f} MiB in use "
            f"(peak {st['peak_bytes_in_use'] / 2**20:.1f} MiB)")
    return "\n".join(lines)
