"""What a traced run adds: the card's busy share over the window (its
utilization counter, NVML), a torch.profiler trace of one eager pass of
the same work, and device times of the kernels' entry points on a second
eager pass for their rooflines.

Nothing here is imported by a ``--trace 0`` run's timed path.
"""
from __future__ import annotations

import contextlib
import ctypes
import inspect
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

from perfbench import yardstick

#: the span that marks the traced pass on the host thread that runs it
WINDOW_SPAN = "perfbench.window"
#: about half a millisecond of the card's clock: the spin that holds the
#: device while the host queues one timed kernel call
HOLD_CYCLES = 1_000_000


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_and_gaps(device: List[Tuple[float, float]], start: float,
                  end: float):
    """The device's busy seconds inside [start, end] (microsecond
    inputs, intervals merged so overlapping operations count once) and
    its idle gaps there, as (gap start, gap end) pairs."""
    busy, gaps, at = 0.0, [], start
    for s, e in _merge(device):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        busy += e - s
        at = max(at, e)
    if end > at:
        gaps.append((at, end))
    return busy * 1e-6, gaps


def attribute_gaps(gaps, host_events) -> Dict[str, float]:
    """Idle seconds by what the host thread was doing: each gap goes to
    the innermost host operation that spans its midpoint (events on one
    thread nest, so a stack sweep finds it), else to no operation."""
    events = sorted(host_events)
    out: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while i < len(events) and events[i][0] <= mid:
            ev = events[i]
            while stack and stack[-1][1] < ev[0]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host operation)"
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return out


def _top(d: Dict[str, float], k: int = 10) -> List[list]:
    return [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])[:k]]


class Nvml:
    """The card's utilization counter (the share of each sample period in
    which a kernel ran), polled from a thread of this process through the
    driver's NVML library; no second process touches the card. The card
    is the one whose UUID torch reports for device 0."""

    def __init__(self, uuid: str, period_s: float = 0.1):
        self.samples: List[int] = []
        self.period_s = period_s
        self._stop = threading.Event()
        self._thread = None
        self.lib = self.handle = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for fn, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetCount_v2", [ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                ("nvmlDeviceGetUUID", [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint]),
                ("nvmlDeviceGetUtilizationRates",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint * 2)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        if lib.nvmlInit_v2() != 0:
            return
        count = ctypes.c_uint()
        lib.nvmlDeviceGetCount_v2(ctypes.byref(count))
        buf = ctypes.create_string_buffer(96)
        for i in range(count.value):
            h = ctypes.c_void_p()
            if (lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)) == 0
                    and lib.nvmlDeviceGetUUID(h, buf, 96) == 0
                    and buf.value.decode().endswith(uuid)):
                self.lib, self.handle = lib, h
                return
        lib.nvmlShutdown()

    def _poll(self):
        util = (ctypes.c_uint * 2)()
        while not self._stop.is_set():
            if self.lib.nvmlDeviceGetUtilizationRates(
                    self.handle, ctypes.byref(util)) == 0:
                self.samples.append(int(util[0]))
            self._stop.wait(self.period_s)

    def __enter__(self):
        if self.lib is not None:
            self._thread = threading.Thread(target=self._poll, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self.lib.nvmlShutdown()
        return False

    def busy_share(self) -> Optional[float]:
        if not self.samples:
            return None
        return sum(self.samples) / (100.0 * len(self.samples))


@contextlib.contextmanager
def busy_window(result: dict):
    """The enclosed window's length on the host clock and the seconds of
    it in which a kernel ran on the card, from the card's utilization
    counter sampled across it (torch.profiler cannot stand in: it sees no
    kernel inside a captured WHILE body)."""
    import torch

    with Nvml(str(torch.cuda.get_device_properties(0).uuid)) as nvml:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    share = nvml.busy_share()
    if share is None:
        raise RuntimeError("NVML gave no utilization sample")
    result.update(busy_s=share * window_s, window_s=window_s,
                  samples=len(nvml.samples))


@contextlib.contextmanager
def eager_trace(result: dict):
    """torch.profiler over the enclosed eager work (every launch its own,
    no captured graph): the 10 device operations that took most time and
    the idle seconds by what the host thread was doing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with warnings.catch_warnings():
        # the profiler warns that it keeps one cycle; there is one
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                yield
                torch.cuda.synchronize()
        events = prof.events()
    window = [e for e in events
              if e.name == WINDOW_SPAN and e.device_type == DeviceType.CPU]
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    thread = window[0].thread
    device, host = [], []
    by_op: Dict[str, float] = {}
    for e in events:
        if e.name == WINDOW_SPAN:
            continue
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((s, t))
            by_op[e.name] = by_op.get(e.name, 0.0) + (t - s) * 1e-6
        elif e.thread == thread:
            host.append((s, t, e.name))
    busy_s, gaps = busy_and_gaps(device, w0, w1)
    result.update(busy_s=busy_s, window_s=(w1 - w0) * 1e-6,
                  device_ops=_top(by_op),
                  idle_gaps=_top(attribute_gaps(gaps, host)))


@contextlib.contextmanager
def kernel_times(device_name: str, kernels=tuple(yardstick.KERNEL_BYTES)):
    """Time every call of the kernels' entry points
    (``repro_torch.kernels.ops``) made inside the block on the device,
    each alone (a spin holds the card while the host queues it, so the
    wrapper's host time does not count), with the bytes it must move.
    Yields a dict that, on exit, holds per kernel ``calls``, ``time_s``
    and ``bound_s`` (bytes over the card's published memory rate)."""
    import torch
    from repro_torch.kernels import ops

    rate = yardstick.hbm_bytes_per_s(device_name)
    pending: Dict[str, list] = {k: [] for k in kernels}
    real = {k: getattr(ops, k) for k in kernels}

    def timed(name):
        fn, nbytes_of = real[name], yardstick.KERNEL_BYTES[name]
        sig = inspect.signature(fn)
        nargs = len(inspect.signature(nbytes_of).parameters)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            torch.cuda._sleep(HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            nbytes = nbytes_of(*bound.args[:nargs])
            pending[name].append((start, end, nbytes))
            return out
        return call

    out: Dict[str, dict] = {}
    for k in kernels:
        setattr(ops, k, timed(k))
    try:
        yield out
    finally:
        for k in kernels:
            setattr(ops, k, real[k])
    torch.cuda.synchronize()
    for k, calls in pending.items():
        if calls:
            out[k] = dict(
                calls=len(calls),
                time_s=sum(s.elapsed_time(e) for s, e, _ in calls) * 1e-3,
                bound_s=sum(b for _, _, b in calls) / rate)
