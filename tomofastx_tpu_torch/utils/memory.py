"""Memory usage reporting.

Counterpart of utils/memory_tools.F90 (host Pss from /proc summed over
ranks); here we report the host's share and, when the run is on a CUDA
device, what the program has allocated there and what the device holds in
all."""

from __future__ import annotations

import torch


def host_memory_gb() -> float:
    """Host proportional-set-size in GB (memory_tools.F90:37-79 reads Pss
    from /proc/self/smaps_rollup)."""
    try:
        with open("/proc/self/smaps_rollup") as f:
            for line in f:
                if line.startswith("Pss:"):
                    return float(line.split()[1]) / 1024**2
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024**2
    except OSError:
        pass
    return 0.0


def device_memory_stats(device) -> dict | None:
    """Bytes this process has allocated on a CUDA device, bytes in use on
    it by anyone, and its total; None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return {
        "device": str(device),
        "bytes_allocated": torch.cuda.memory_allocated(device),
        "bytes_in_use": total - free,
        "bytes_limit": total,
    }


def report(prefix: str = "", device="cuda") -> str:
    lines = [f"{prefix}MEMORY USED (host) [GB] = {host_memory_gb():.3f}"]
    s = device_memory_stats(device)
    if s is not None:
        lines.append(
            f"{prefix}MEMORY USED ({s['device']}) [GB] = "
            f"{s['bytes_allocated'] / 1024**3:.3f} allocated, "
            f"{s['bytes_in_use'] / 1024**3:.3f} / {s['bytes_limit'] / 1024**3:.3f} in use"
        )
    return "\n".join(lines)
