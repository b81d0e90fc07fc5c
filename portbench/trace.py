"""Reading a ``torch.profiler`` trace of the card: the device's busy time
as the union of its kernels' intervals, the kernels by name (from a trace
of the card's activity alone), and the longest idle gaps with what the
host was doing in them (from a trace that records the host's ops too).

The filter of device kernels (CUDA events that are not user annotations)
is copied from ``rl_selfplay_mnk_tpu_torch/utils/profiling.py``
(``kernel_times``); the busy time there is a sum of kernel times, here the
union of their intervals, so that kernels that overlap count once.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def device_kernels(prof) -> list:
    """(start us, end us, name) of every kernel in the trace, by start."""
    import torch

    out = []
    for evt in prof.events():
        annotation = getattr(evt, "is_user_annotation", False)
        if evt.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            out.append((evt.time_range.start, evt.time_range.end, evt.name))
    out.sort()
    return out


def host_events(prof) -> list:
    """(start us, end us, name) of the host's ops and spans, by start."""
    import torch

    out = [(evt.time_range.start, evt.time_range.end, evt.name) for evt in prof.events()
           if evt.device_type == torch.autograd.DeviceType.CPU]
    out.sort()
    return out


def busy_intervals(kernels) -> list:
    """The union of the kernels' intervals, as sorted disjoint (start, end)."""
    merged = []
    for start, end, _ in kernels:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def kernel_seconds(kernels) -> dict:
    """kernel name -> (device seconds, launches)."""
    out = defaultdict(lambda: [0.0, 0])
    for start, end, name in kernels:
        rec = out[name]
        rec[0] += (end - start) / 1e6
        rec[1] += 1
    return dict(out)


def idle_gaps(merged, host, count: int = 10) -> list:
    """The ``count`` longest gaps between busy intervals, each named by the
    innermost host op that was running when it began: [[name, seconds]]."""
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:count]
    starts = [h[0] for h in host]
    out = []
    for length, at in gaps:
        # scanning back by start, the first op still running at ``at`` is the innermost
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and host[i][1] < at:
            i -= 1
        name = f"host: {host[i][2]}" if i >= 0 else "host: nothing traced"
        out.append([name, length / 1e6])
    return out


def summarise(prof, window_s: float) -> dict:
    """busy_s, the kernels by name and the top device ops of a traced
    window of ``window_s`` host seconds."""
    kernels = device_kernels(prof)
    merged = busy_intervals(kernels)
    busy = sum(end - start for start, end in merged) / 1e6
    by_name = kernel_seconds(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "busy_s": busy,
        "window_s": window_s,
        "kernels": by_name,
        "launches": len(kernels),
        "device_ops": [[name[:120], sec] for name, (sec, _) in top],
    }
