"""The traced slice of a run: device activity from a torch.profiler trace.

The run profiles a few whole solves of its window, each call to the
program under a `record_function` span (`SPAN`); everything here reads
the exported chrome trace inside those spans, so that the benchmark's own
work between them (making b, copying answers off the card) is left out.  Kernels are put into layers by name with
the map under `layers/`: one directory a layer, each file in it a list of
name fragments, one a line.  A kernel belongs to the layer of the
fragment that starts latest in its name (the innermost template argument
of a templated name, e.g. a copy functor inside an elementwise kernel);
of two starting at one place, the longer decides.
"""
from __future__ import annotations

import bisect
import collections
import json
from pathlib import Path

#: the span around each profiled call to the program
SPAN = "solverbench.slice"
#: trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of host activity, for labelling the device's idle gaps
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAYERS = Path(__file__).resolve().parent / "layers"


def layer_map(root: Path = LAYERS):
    """[(fragment, layer)] from every `<layer>/<entry>.txt` under root."""
    pairs = []
    for path in sorted(root.glob("*/*.txt")):
        for line in path.read_text().splitlines():
            if line.strip() and not line.startswith("#"):
                pairs.append((line.strip(), path.parent.name))
    return pairs


def layer_of(name: str, fragments) -> str:
    """The layer of a device activity's name, "other" if none matches."""
    best, key = "other", None
    for frag, layer in fragments:
        pos = name.rfind(frag)
        if pos >= 0 and (key is None or (pos, len(frag)) > key):
            best, key = layer, (pos, len(frag))
    return best


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0][:100]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceSlice:
    """The device activity of the profiled solves.  Times in the trace
    are µs; everything returned is seconds."""

    def __init__(self, events, fragments=None):
        self.spans = _merge((e["ts"], e["ts"] + e["dur"]) for e in events
                            if e.get("cat") == "user_annotation"
                            and e.get("name") == SPAN)
        if not self.spans:
            raise ValueError(f"the trace holds no {SPAN!r} span")
        starts = [a for a, _ in self.spans]

        def span_end(t):
            """The end of the span holding time t, None outside them."""
            i = bisect.bisect_right(starts, t) - 1
            return self.spans[i][1] if i >= 0 and t < self.spans[i][1] \
                else None
        self.ops = [e for e in events if e.get("cat") in DEVICE_CATS
                    and span_end(e["ts"]) is not None]
        self.host = sorted((e for e in events if e.get("cat") in HOST_CATS
                            and e.get("name") != SPAN
                            and any(e["ts"] < b and e["ts"] + e.get("dur", 0)
                                    > a for a, b in self.spans)),
                           key=lambda e: e["ts"])
        self.fragments = layer_map() if fragments is None else fragments
        self.busy = _merge((e["ts"], min(e["ts"] + e.get("dur", 0),
                                         span_end(e["ts"])))
                           for e in self.ops)

    @classmethod
    def from_file(cls, path, fragments=None):
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if e.get("ph") == "X"]
        return cls(events, fragments)

    @property
    def window_s(self) -> float:
        """The spans' length, summed."""
        return sum(b - a for a, b in self.spans) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    @property
    def kernel_launches(self) -> int:
        return sum(1 for e in self.ops if e.get("cat") == "kernel")

    def layer_seconds(self) -> dict:
        """Device seconds by layer (summed durations)."""
        out = collections.defaultdict(float)
        for e in self.ops:
            out[layer_of(e["name"], self.fragments)] += e.get("dur", 0) * 1e-6
        return dict(out)

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device activities that took most time."""
        out = collections.defaultdict(float)
        for e in self.ops:
            out[short_name(e["name"])] += e.get("dur", 0) * 1e-6
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def _gaps(self):
        """The idle intervals of the device inside the spans."""
        busy = iter(self.busy)
        nxt = next(busy, None)
        for s0, s1 in self.spans:
            t = s0
            while nxt is not None and nxt[0] < s1:
                if nxt[0] > t:
                    yield t, nxt[0]
                t = max(t, nxt[1])
                nxt = next(busy, None)
            if s1 > t:
                yield t, s1

    def idle_gaps(self, top: int = 10):
        """[[host activity, seconds]]: the device's idle time in the slice,
        summed by what the host was doing at each gap's middle (the
        latest-started host event still running there; "python" where
        none was)."""
        starts = [e["ts"] for e in self.host]
        out = collections.defaultdict(float)
        for a, b in self._gaps():
            mid, label = (a + b) / 2, "python"
            i = bisect.bisect_right(starts, mid) - 1
            for e in self.host[max(0, i - 64):i + 1][::-1]:
                if e["ts"] + e.get("dur", 0) >= mid:
                    label = short_name(e["name"])
                    break
            out[label] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:top]]
