"""What a traced run reads from the device and from the kernel wrappers.

`KernelWork` wraps the program's Python kernel wrappers for the traced
window and sums each kernel's bound (`roofline`) over the calls it sees,
from the calls' shapes.  `DeviceTrace` reads `torch.profiler`'s device
events (CUDA activity only, so the trace holds kernels and copies, not
every host operation): the seconds in which anything ran on the card,
each kernel's device seconds, the top operations, and the idle gaps,
each labelled by the innermost `obs` span the host was in.
"""
from __future__ import annotations

import numpy as np

from hbench import roofline

# kernel -> the symbol its device events carry
KERNEL_SYMBOLS = {
    "eval_gadget": "eval_gadget_kernel",
    "keymul": "negacyclic_mul_kernel<false>",
}


class KernelWork:
    """[calls, bound seconds] per kernel, summed over the wrapper calls
    made while it is entered (the bound needs the card's `peaks`)."""

    def __init__(self, peaks):
        self.peaks = peaks
        self.sums = {k: [0, 0.0] for k in KERNEL_SYMBOLS}

    def _add(self, kernel: str, work: tuple) -> None:
        s = self.sums[kernel]
        s[0] += 1
        if self.peaks is not None:
            s[1] += roofline.bound_s(*work, self.peaks)

    def __enter__(self) -> "KernelWork":
        from repro_torch.kernels import cmp_eval as CK
        from repro_torch.kernels import ntt as NK
        self._inner = (CK.eval_coeff0_gadget, NK.negacyclic_mul_ntt)
        eval_inner, mul_inner = self._inner

        def eval_gadget(uniq_c0, uniq_c1, row_offset, rows, sel, bounds_c0,
                        bounds_c1, cek_rev, *args, **kwargs):
            out = eval_inner(uniq_c0, uniq_c1, row_offset, rows, sel,
                             bounds_c0, bounds_c1, cek_rev, *args, **kwargs)
            K, D, _, n = cek_rev.shape
            if rows:
                self._add("eval_gadget", roofline.gadget_eval_work(
                    len(sel), rows, K, n, D, bounds_c1.dim() == 4,
                    len(set(np.asarray(sel).tolist()))))
            return out

        def keymul(a, b_br, ring, *args, **kwargs):
            out = mul_inner(a, b_br, ring, *args, **kwargs)
            rows = a.numel() // (ring.num_towers * ring.n)
            if rows:
                self._add("keymul", roofline.key_mul_work(
                    rows, ring.num_towers, ring.n))
            return out
        CK.eval_coeff0_gadget, NK.negacyclic_mul_ntt = eval_gadget, keymul
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import cmp_eval as CK
        from repro_torch.kernels import ntt as NK
        CK.eval_coeff0_gadget, NK.negacyclic_mul_ntt = self._inner


class DeviceTrace:
    """Device events of one profiled window, as (name, start, end) in
    nanoseconds on the profiler's clock (Unix time)."""

    def __init__(self, events: list):
        self.events = sorted(events, key=lambda e: e[1])

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        evs = [(e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        return cls(evs)

    def busy_intervals(self) -> list:
        """The union of the events' intervals, merged, in time order."""
        out: list = []
        for _, lo, hi in self.events:
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e9

    def kernel_s(self, kernel: str) -> float:
        sym = KERNEL_SYMBOLS[kernel]
        return sum(hi - lo for name, lo, hi in self.events
                   if sym in name) / 1e9

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the k operations with the most device
        time (names cut to 100 characters)."""
        by: dict = {}
        for name, lo, hi in self.events:
            by[name[:100]] = by.get(name[:100], 0.0) + (hi - lo) / 1e9
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, spans: list, offset_ns: int, k: int = 10) -> list:
        """[[label, seconds]]: the card's idle time between events,
        summed by the innermost span the host was in at each gap's
        middle (`spans`: (name, t0, t1) on the host's perf clock in
        seconds, nested; `offset_ns` maps that clock to the profiler's),
        the k largest."""
        busy = self.busy_intervals()
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        mids = sorted(((lo + hi) / 2, hi - lo) for lo, hi in gaps)
        spans = sorted(spans, key=lambda s: s[1])
        by: dict = {}
        stack: list = []
        i = 0
        for mid, dur in mids:
            t = (mid - offset_ns) / 1e9
            while i < len(spans) and spans[i][1] <= t:
                while stack and stack[-1][2] < spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            label = stack[-1][0] if stack else "outside any span"
            by[label] = by.get(label, 0.0) + dur / 1e9
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]
