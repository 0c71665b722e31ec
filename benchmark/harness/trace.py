"""The device side of a traced run: ``torch.profiler`` over the card's
activity alone (no host operator events, so the profiler adds little to
the host's time), read back as the device's intervals.

``busy_s`` is the length of the union of every device interval (kernels,
copies, fills); ``window_s`` is the host's synchronized wall time of the
traced call. A traced call in which no device interval was recorded is an
error, never a zero.
"""

from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict


@dataclasses.dataclass
class Trace:
    #: (name, start ns, duration ns) of every device interval, by start
    intervals: list
    window_s: float

    @property
    def kernels(self) -> list:
        """The intervals that are kernels (not copies or fills)."""
        return [iv for iv in self.intervals if not _is_transfer(iv[0])]

    def busy_s(self) -> float:
        return sum(end - start for start, end, _, _ in self._merged()) / 1e9

    def _merged(self) -> list:
        """Union of the intervals: (start, end, first name, last name)."""
        out = []
        for name, start, dur in self.intervals:
            end = start + dur
            if out and start <= out[-1][1]:
                s, e, first, last = out[-1]
                out[-1] = (s, max(e, end), first, name if end >= e else last)
            else:
                out.append((start, end, name, name))
        return out

    def matching(self, pattern: str) -> list:
        """Intervals whose name contains ``pattern``."""
        return [iv for iv in self.intervals if pattern in iv[0]]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps between device intervals, named by the kernels either side of
        them (what the host did between those launches), in seconds."""
        ops = defaultdict(int)
        for name, _, dur in self.intervals:
            ops[short_name(name)] += dur
        gaps = defaultdict(int)
        merged = self._merged()
        for (_, end, _, last), (start, _, first, _) in zip(merged, merged[1:]):
            gaps[f"{short_name(last)} -> {short_name(first)}"] += start - end

        def ranked(d):
            return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def _is_transfer(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments or parameters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


def profile(torch, fn) -> tuple[object, Trace]:
    """Run ``fn()`` under the profiler (device activity only), synchronize,
    and return its result with the device intervals and the wall time."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    intervals = sorted(
        ((e.name(), int(e.start_ns()), int(e.duration_ns()))
         for e in prof.profiler.kineto_results.events() if e.device_type() == cuda),
        key=lambda iv: iv[1])
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity in the traced window")
    return result, Trace(intervals=intervals, window_s=wall)
