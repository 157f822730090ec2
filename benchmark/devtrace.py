"""Reduction of a torch.profiler trace to busy time, kernels and gaps.

Busy time is the union of the kernel events' intervals over the traced
span, so overlapping kernels and the host-side op events that mirror a
kernel are counted once (measure_gpu.py notes that key_averages() counts
each kernel twice).  Idle gaps between kernels are labelled by the
innermost host range (a TRACE stage or the harness's own) that covers
the gap's midpoint.
"""
from __future__ import annotations


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, label_names):
    """dict(window_s, busy_s, kernels [(name, start_us, end_us)],
    device_ops [[name, s]], idle_gaps [[label, s]]) for the span of the
    host ranges named "bench.sample"."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    samples = [e for e in evs if e.name == "bench.sample"]
    if not samples:
        return None
    w0 = min(e.time_range.start for e in samples)
    w1 = max(e.time_range.end for e in samples)
    # device events less the profiler's mirrors of host ranges
    kern = [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1))
            for e in evs if e.device_type == DeviceType.CUDA
            and e.name not in label_names
            and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > w0 and e.time_range.start < w1]
    busy = _union([(a, b) for _, a, b in kern if b > a])
    busy_us = sum(b - a for a, b in busy)
    by = {}
    for name, a, b in kern:
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in evs if e.device_type == DeviceType.CPU
                     and e.name in label_names), key=lambda r: r[0])
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label, width = "outside TRACE stages", None
        for s, e, name in ranges:
            if s > mid:
                break
            if e >= mid and (width is None or e - s < width):
                label, width = name, e - s
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                kernels=kern, device_ops=top(by), idle_gaps=top(gaps))
