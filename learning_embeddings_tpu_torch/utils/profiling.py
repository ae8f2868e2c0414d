"""Profiling on ``torch.profiler``: the port of
``learning_embeddings_tpu/utils/profiling.py``.

``trace_steps`` runs a step callable under the profiler and writes a
chrome trace; ``summarize_trace`` sums that trace's device time by op
class. Only device activity counts (CUDA kernels, memcpys and memsets):
host ranges and annotations such as ``Optimizer.step#Adam.step`` span
kernels that are counted on their own, so they are left out. A CPU run
has no device activity, and its summary is empty.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import Callable, List, Tuple

import torch

__all__ = ["trace_steps", "summarize_trace", "TRACE_FILE"]

TRACE_FILE = "trace.json"

#: chrome-trace categories of device activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_steps(step_fn: Callable, n_steps: int, trace_dir: str,
                device="cuda", sync: Callable = None) -> str:
    """Run `step_fn()` `n_steps` times under the profiler (CPU activity,
    and CUDA activity when `device` is a card); writes
    `trace_dir`/trace.json and returns `trace_dir`. `sync(out)` forces
    the last output; by default the card is synchronised."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = None
        for _ in range(n_steps):
            out = step_fn()
        if sync is not None:
            sync(out)
        elif on_card:
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return trace_dir


def summarize_trace(trace_dir: str, n_steps: int = 1,
                    top_k: int = 20) -> List[Tuple[str, float, float]]:
    """[(op class, device ms per step, share of the device time)], the
    largest first; an op class is a kernel name without trailing
    digits and dots."""
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    cat = collections.Counter()
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
                and e.get("dur")):
            cat[re.sub(r"[.\d]+$", "", e["name"])] += float(e["dur"])
    total = sum(cat.values()) or 1.0
    return [(name, us / n_steps / 1e3, us / total)
            for name, us in cat.most_common(top_k)]
