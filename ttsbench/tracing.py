"""The traced stretches of a run: `torch.profiler` (CUPTI) over a few
seconds at a time, at several points of the steady window, reduced after
the window closes.

Device operations are grouped by the correlation id that ties each kernel
to the runtime call that launched it: a CUDA-graph replay is one group.
A group holding K1 kernels is a decode graph, one holding K6 kernels a
vocoder graph; a `cudaGraphLaunch` group with neither is an admission
graph. Decode and vocoder groups are matched to the launch spans the
benchmark recorded (`serve.LaunchLog`): the latest span opened in the
same stretch before the group's runtime call, when it is of the group's
kind (`match`)."""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional

K1 = re.compile(r"attention_(mma|chunk|combine)")
K6 = re.compile(r"residual_unit_kernel")


class Trace:
    def __init__(self):
        self.prof = None
        self.t0 = 0
        self.stretches: List[tuple] = []     # (t0, t1, raw results)

    def warm(self) -> None:
        """Start and stop once at set-up: the first start initialises
        CUPTI and the profiler (seconds), which must not fall in the
        window."""
        self.start()
        self.stop()
        self.stretches = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        # device activity only: the runtime calls come with it (CUPTI)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        """Stop tracing and keep the stretch's raw results: the profiler's
        own Python event tree over some 10⁵ kernels is not needed here."""
        import torch

        if torch.cuda.is_available():
            # what was launched in the stretch ends inside it
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self.stretches.append((self.t0, t1,
                               torch.autograd._disable_profiler()))
        self.prof = None

    def reduce(self) -> Dict:
        """GPU operations in the traced stretches and their groups."""
        from torch.autograd import DeviceType

        gpu, runtime = [], {}
        for _, _, results in self.stretches:
            for e in results.events():
                if e.device_type() == DeviceType.CUDA:
                    link = e.linked_correlation_id() or e.correlation_id()
                    gpu.append((e.start_ns(), e.duration_ns(), e.name(),
                                link))
                elif e.name().startswith("cuda"):
                    runtime[e.correlation_id()] = (e.name(), e.start_ns())
        spans = [(a, b) for a, b, _ in self.stretches]
        self.stretches = []
        gpu.sort()
        groups: Dict[int, dict] = {}
        for ev in gpu:
            g = groups.setdefault(ev[3], {"ops": [], "kind": "other"})
            g["ops"].append(ev)
        for cid, g in groups.items():
            names = [op[2] for op in g["ops"]]
            rt = runtime.get(cid)
            g["t"] = rt[1] if rt else g["ops"][0][0]
            if any(K1.search(n) for n in names):
                g["kind"] = "decode"
            elif any(K6.search(n) for n in names):
                g["kind"] = "vocoder"
            elif rt and rt[0] == "cudaGraphLaunch":
                g["kind"] = "admission"
            g["dur_ns"] = sum(op[1] for op in g["ops"])
        linked = sum(1 for op in gpu if op[3])
        return {"spans": spans, "ops": gpu,
                "groups": sorted(groups.values(), key=lambda g: g["t"]),
                "linked": linked}


def inside(red: Dict, t0: int, t1: int) -> bool:
    """Whether [t0, t1] lies inside one traced stretch."""
    return any(a <= t0 and t1 <= b for a, b in red["spans"])


def match(red: Dict, spans: List[dict], kind: str) -> List[tuple]:
    """(group, span) pairs of `kind`: a group whose runtime call and
    operations lie inside one traced stretch takes the latest launch span
    opened in that stretch before its runtime call, if that span is of
    `kind` and no other group took it (a launch's later groups, such as
    an output copy, and a graph launched by an unrecorded call take
    none)."""
    spans = sorted(spans, key=lambda s: s["t"])
    times = [s["t"] for s in spans]
    out, used = [], set()
    for g in red["groups"]:
        if g["kind"] != kind:
            continue
        last = g["ops"][-1]
        home = [(a, b) for a, b in red["spans"]
                if a <= min(g["t"], g["ops"][0][0])
                and max(g["t"], last[0] + last[1]) <= b]
        if not home:
            continue
        j = bisect.bisect_right(times, g["t"]) - 1
        if j < 0 or spans[j]["t"] < home[0][0] or j in used \
                or spans[j]["kind"] != kind:
            continue
        used.add(j)
        out.append((g, spans[j]))
    return out


def busy(ops: List[tuple], t0: int, t1: int) -> List[tuple]:
    """The merged intervals in which some device operation ran."""
    iv = sorted((max(s, t0), min(s + d, t1)) for s, d, _, _ in ops
                if s < t1 and s + d > t0)
    out: List[list] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _busy_all(red: Dict) -> List[tuple]:
    """The busy intervals of every stretch, each stretch on its own."""
    return [iv for a, b in red["spans"] for iv in busy(red["ops"], a, b)]


def breakdown(red: Dict) -> Dict:
    """The ten device operations that took most time and the ten longest
    idle gaps inside a stretch, each named by what the device waited for:
    the kind of the group whose operation ended it."""
    tot: Dict[str, int] = {}
    for s, d, name, _ in red["ops"]:
        if inside(red, s, s):
            tot[name[:160]] = tot.get(name[:160], 0) + d
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    # a gap is named by the next graph replay after it (its input copies
    # come first), else by the operation that ends it
    graphs = sorted((g["ops"][0][0], g["kind"]) for g in red["groups"]
                    if g["kind"] != "other")
    firsts = [t for t, _ in graphs]
    name_at = {op[0]: op[2][:60] for op in red["ops"]}
    gaps = []
    for t0, t1 in red["spans"]:
        iv = busy(red["ops"], t0, t1)
        for a, b in zip(iv, iv[1:]):
            j = bisect.bisect_left(firsts, b[0])
            if j < len(graphs) and graphs[j][0] - b[0] < 5_000_000:
                what = f"before a {graphs[j][1]} graph"
            else:
                what = f"before {name_at.get(b[0], 'an operation')}"
            gaps.append((b[0] - a[1], what))
    gaps.sort(reverse=True)
    return {"device_ops": [[n, d / 1e9] for n, d in ops],
            "idle_gaps": [[n, g / 1e9] for g, n in gaps[:10]]}


def busy_s(red: Dict) -> float:
    return sum(b - a for a, b in _busy_all(red)) / 1e9


def window_s(red: Dict) -> float:
    return sum(b - a for a, b in red["spans"]) / 1e9
