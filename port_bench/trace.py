"""The reduction of a profiler trace (``torch.profiler`` over the CPU and
the card) to what the per-layer metrics read: device operations by name,
the time the device was busy inside the harness's own spans, and the idle
gaps by what the host was doing."""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]  # microseconds, the profiler's clock

WINDOW = "bench.window"  # the harness's span around a traced region


def _union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _clip(intervals: Sequence[Interval], within: Sequence[Interval]) -> List[Interval]:
    out = []
    for ws, we in within:
        out.extend((max(s, ws), min(e, we)) for s, e in intervals if s < we and e > ws)
    return out


class Summary:
    """Device operations (kernels, copies, fills) and host events of one
    profile, and the harness's ``bench.*`` spans."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        self.spans: Dict[str, List[Interval]] = {}
        for ev in prof.events():
            start, end = float(ev.time_range.start), float(ev.time_range.end)
            if ev.name.startswith("bench."):
                if ev.device_type == DeviceType.CPU:
                    self.spans.setdefault(ev.name, []).append((start, end))
            elif ev.device_type == DeviceType.CUDA:
                if not getattr(ev, "is_user_annotation", False):
                    self.device.append((start, end, ev.name))
            else:
                self.host.append((start, end, ev.name))
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    def within(self, span: str = WINDOW) -> List[Interval]:
        return self.spans.get(span, [])

    def window_s(self, span: str = WINDOW) -> float:
        return sum(e - s for s, e in self.within(span)) / 1e6

    def busy(self, span: str = WINDOW) -> List[Interval]:
        """The union of the device's operations inside ``span``."""
        return _union(_clip([(s, e) for s, e, _ in self.device], self.within(span)))

    def busy_s(self, span: str = WINDOW) -> float:
        return sum(e - s for s, e in self.busy(span)) / 1e6

    def kernels(self, pattern: str, span: str = WINDOW) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name matches
        ``pattern`` and that start inside ``span``."""
        rx = re.compile(pattern)
        within = self.within(span)
        hits = [(s, e) for s, e, name in self.device if rx.search(name)
                and any(ws <= s < we for ws, we in within)]
        return len(hits), sum(e - s for s, e in hits) / 1e6

    def top_ops(self, n: int = 10, span: str = WINDOW) -> List[List]:
        """The ``n`` device operations that took most time, by name."""
        by: Dict[str, float] = {}
        for s, e in self.within(span):
            for ds, de, name in self.device:
                if s <= ds < e:
                    by[name[:120]] = by.get(name[:120], 0.0) + (de - ds) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost host event running at ``t``."""
        i = bisect.bisect_right(self._host_starts, t)
        best: Optional[Tuple[float, str]] = None
        for s, e, name in reversed(self.host[max(0, i - 400): i]):
            if e >= t and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else "(no host event)"

    def idle_gaps(self, n: int = 10, span: str = WINDOW) -> List[List]:
        """Idle seconds inside ``span``, summed by the innermost host event
        running at each gap's middle; the ``n`` largest."""
        by: Dict[str, float] = {}
        for ws, we in self.within(span):
            busy = _union(_clip([(s, e) for s, e, _ in self.device], [(ws, we)]))
            edges = [ws] + [x for iv in busy for x in iv] + [we]
            for gs, ge in zip(edges[0::2], edges[1::2]):
                if ge > gs:
                    name = self._host_at((gs + ge) / 2)[:120]
                    by[name] = by.get(name, 0.0) + (ge - gs) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def roofline(measures, kinds: Sequence[str], span: str = WINDOW) -> Optional[float]:
    """The share (%) of the summed least times of the port's launches of
    ``kinds`` (flash_fwd, flash_bwd_dkdv, flash_bwd_dq) in their summed
    device time; None where the trace holds none of them. The launches the
    trace shows have to be those the port counted."""
    if measures.trace is None:
        return None
    bound = seconds = 0.0
    for kind in kinds:
        n, s = measures.trace.kernels(rf"{kind}_bf16_kernel", span)
        if n == 0:
            continue
        counted = measures.launches.get(kind, 0)
        if n != counted:
            raise ValueError(f"the trace holds {n} launches of {kind}, the port counted {counted}")
        bound += measures.bounds[kind]
        seconds += s
    return 100.0 * bound / seconds if seconds > 0 else None
