"""The reduction from a ``torch.profiler`` window to what the per-layer
metrics read: every device operation (kernels, memcpys, memsets) with its
start and end, the device's busy time (the union of those intervals), and
the breakdown the result line carries.

Ranges that annotate the device timeline (``Optimizer.step#Adam.step``,
``ProfilerStep``) span operations counted on their own and are left out,
as ``utils/profiling.py`` of the measured package leaves them out.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Tuple

import numpy as np

#: name prefixes of device-side annotations, not operations
_ANNOTATIONS = ("ProfilerStep", "Optimizer.")


class Window:
    """One traced window: `ops` (name, start_us, end_us) of the device,
    `host` (name, start_us, end_us) of the host, and its length."""

    def __init__(self, ops: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.host = host
        self.window_s = float(window_s)
        self.busy_s = _union_s([(s, e) for _, s, e in self.ops])

    def seconds_by(self, match) -> float:
        """Device seconds of the ops whose name `match(name)` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e6

    def by_name(self) -> Dict[str, float]:
        """Device seconds by op name, trailing digits and dots cut."""
        out = collections.Counter()
        for n, s, e in self.ops:
            out[re.sub(r"[.\d]+$", "", n)] += (e - s) / 1e6
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in self.idle_gaps(top)]}

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """Idle device time by what the host was doing: each gap between
        device operations is named after the innermost host range around
        its middle ("host python" where none is open); the names with the
        most idle seconds, of the 500 longest gaps. A profile of the card's
        activity alone holds the CUDA runtime's calls as its host ranges,
        so a gap reads as a wait (``cudaStreamSynchronize``, a copy) or as
        the host's own work between calls ("host python")."""
        gaps, end = [], None
        for _, s, e in self.ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:500]
        if not gaps:
            return []
        starts = np.array([h[1] for h in self.host])
        ends = np.array([h[2] for h in self.host])
        total = collections.Counter()
        for s, e in gaps:
            mid = 0.5 * (s + e)
            name = "host python"
            if len(starts):
                inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
                if len(inside):
                    i = inside[np.argmin(ends[inside] - starts[inside])]
                    name = self.host[i][0]
            total[name] += (e - s) / 1e6
        return total.most_common(top)


def _union_s(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def from_profiler(prof, window_s: float) -> Window:
    """A Window from a finished ``torch.profiler.profile``."""
    ops, host = [], []
    for evt in prof.events():
        name = evt.name
        t = evt.time_range
        if str(evt.device_type).endswith("CUDA"):
            if getattr(evt, "is_user_annotation", False) or \
                    name.startswith(_ANNOTATIONS):
                continue
            if t.end > t.start:
                ops.append((name, float(t.start), float(t.end)))
        else:
            host.append((name, float(t.start), float(t.end)))
    return Window(ops, host, window_s)
