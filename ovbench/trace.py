"""The traced run's reading of ``torch.profiler``, from its events in
memory (no trace file is written).

`Trace` holds the device's kernel records (name, start, end in ns), the
host spans the breakdown labels gaps with, and the window's bounds on the
profiler's clock (two marker ranges the harness records).  `complete`
compares the records of each hand-written kernel with the program's launch
counters over the same span: where they disagree the profiler lost records,
and no share of the device is read from the trace.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

START, END = "ovbench.window_start", "ovbench.window_end"
SPANS = ("convert_batch", "ovbench.call")   # host spans that label an idle gap, innermost first

# the hand-written kernels: the port's launch counter (ops module) → the
# names of its kernels in the trace
KERNELS = {
    "stft_cuda": ("stft_fft_kernel", "stft_dft_kernel"),
    "wn_cuda": ("wn_stack_kernel",),
    "coupling_cuda": ("coupling_kernel",),
    "mrf_cuda": ("mrf_stage_kernel",),
    "tail_cuda": ("tail_stage_kernel",),
}


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start_ns, end_ns), by start
    spans: list = field(default_factory=list)     # (name, start_ns, end_ns)
    t0: int = 0
    t1: int = 0
    complete: bool = True

    @staticmethod
    def read(prof) -> "Trace":
        from torch.autograd import DeviceType

        tr = Trace()
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith(("Memcpy", "Memset")):
                    continue
                s = _ns(e, "start")
                tr.kernels.append((name, s, s + int(e.duration_ns())))
            elif name in (START, END):
                if name == START:
                    tr.t0 = _ns(e, "start")
                else:
                    tr.t1 = _ns(e, "start")
            elif name in SPANS:
                s = _ns(e, "start")
                tr.spans.append((name, s, s + int(e.duration_ns())))
        tr.kernels.sort(key=lambda k: k[1])
        return tr

    def check(self, launches: dict) -> bool:
        """Records of each hand-written kernel against its launch counter's
        rise (`launches`: ops module → launches); prints each disagreement."""
        ok = True
        for module, names in KERNELS.items():
            seen = sum(1 for k in self.kernels if any(n in k[0] for n in names))
            if seen != launches.get(module, 0):
                print(f"trace incomplete: {seen} records of {module}'s kernels, {launches.get(module, 0)} "
                      "launches counted", file=sys.stderr)
                ok = False
        self.complete = ok
        return ok

    def time_of(self, names: tuple) -> float:
        """Seconds of device time in kernels whose name holds one of `names`."""
        return sum(k[2] - k[1] for k in self.kernels if any(n in k[0] for n in names)) / 1e9

    def busy(self) -> float:
        """Seconds inside the window in which a kernel ran (the union of
        their intervals)."""
        busy, end = 0, self.t0
        for _, s, e in self.kernels:
            s, e = max(s, end), min(e, self.t1)
            if e > s:
                busy += e - s
            end = max(end, min(e, self.t1))
        return busy / 1e9

    def window(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def top_kernels(self, n: int = 10) -> list:
        by: dict[str, int] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0) + (e - s)
        return [[name[:120], t / 1e9] for name, t in sorted(by.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps inside the window in which no kernel ran, each
        named by the host span open at its middle."""
        gaps, end = [], self.t0
        for _, s, e in self.kernels:
            if s > end and s <= self.t1:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.t1:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            label = "none"
            for span in SPANS:
                if any(s <= mid <= e for name, s, e in self.spans if name == span):
                    label = span
                    break
            out.append([label, (b - a) / 1e9])
        return out
