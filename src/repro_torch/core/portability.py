"""Performance-portability metrics (paper §VI-A) — port of
``repro.core.portability``.

* ``performance_penalty``  = (T3_x − T3_baseline) / T3_baseline × 100   [%]
* ``portability_score`` Φ  = T3_baseline / T3_hardware_agnostic ∈ [0, 1]
* ``overhead_ratio``       = T1 / T4, with T4 = T1 + T2 + T3

T-terms (paper definitions): T1 = HALO framework overhead (agent/dispatch
time only), T2 = hardware data-transfer time, T3 = kernel execution time,
T4 = total runtime.  Buffers stay on the device between calls, so T2 ≈ 0.
On the card T3 is timed with CUDA events around each call; on the CPU with
the host clock.  ``chip_smoke.py`` prints one :class:`KernelReport` per
kernel.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Sequence

import torch

__all__ = ["KernelReport", "ServeReport", "Timing", "overhead_ratio",
           "percentile_nearest", "performance_penalty", "portability_score",
           "time_fn"]


@dataclasses.dataclass
class Timing:
    mean_s: float
    std_s: float
    median_s: float
    runs: int
    device: str          # where the time was taken: "cuda:0 (<card>)" or "cpu"

    @property
    def mean_us(self) -> float:
        return self.mean_s * 1e6


def time_fn(fn: Callable, *args, device="cuda", warmup: int = 2,
            iters: int = 10, **kwargs) -> Timing:
    """Time ``fn(*args, **kwargs)``.  On a CUDA ``device`` each call is
    bracketed by CUDA events on the current stream (device time, after
    ``warmup`` untimed calls); on ``"cpu"`` by the host clock."""
    device = torch.device(device)
    samples: List[float] = []
    if device.type == "cuda":
        for _ in range(warmup):
            fn(*args, **kwargs)
        stream = torch.cuda.current_stream(device)
        events = []
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args, **kwargs)
            end.record(stream)
            events.append((start, end))
        torch.cuda.synchronize(device)
        samples = [s.elapsed_time(e) / 1e3 for s, e in events]
        where = f"{device} ({torch.cuda.get_device_name(device)})"
    else:
        for _ in range(warmup):
            fn(*args, **kwargs)
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            samples.append(time.perf_counter() - t0)
        where = "cpu"
    return Timing(mean_s=statistics.fmean(samples),
                  std_s=statistics.pstdev(samples),
                  median_s=statistics.median(samples), runs=iters, device=where)


def performance_penalty(t3_impl: float, t3_baseline: float) -> float:
    """Percent slowdown vs. the hardware-optimized baseline (Table VI)."""
    return (t3_impl - t3_baseline) / t3_baseline * 100.0


def portability_score(t3_baseline: float, t3_agnostic: float) -> float:
    """Φ = T3_baseline / T3_hardware-agnostic (Table VII). 1.0 = perfect."""
    return t3_baseline / t3_agnostic


def overhead_ratio(t1: float, t4: float) -> float:
    """T1/T4 (Table VIII)."""
    return t1 / t4 if t4 > 0 else 0.0


def percentile_nearest(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence (request
    latency reporting in the serving launcher)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


@dataclasses.dataclass
class KernelReport:
    """One row of the paper's evaluation: a kernel on one device class."""
    kernel: str
    device: str
    t1_s: float
    t3_baseline_s: float
    t3_halo_s: float
    t3_agnostic_s: float   # deliberately unoptimized hardware-agnostic impl

    @property
    def t4_s(self) -> float:
        return self.t1_s + self.t3_halo_s  # T2≈0: buffers stay on the device

    @property
    def halo_score(self) -> float:
        return portability_score(self.t3_baseline_s, self.t3_halo_s)

    @property
    def agnostic_score(self) -> float:
        return portability_score(self.t3_baseline_s, self.t3_agnostic_s)

    @property
    def halo_gain(self) -> float:
        """HALO/HA score ratio — the paper's bold '(Nx)' column."""
        return self.halo_score / max(self.agnostic_score, 1e-30)

    @property
    def overhead(self) -> float:
        return overhead_ratio(self.t1_s, self.t4_s)

    def csv(self) -> str:
        return (f"{self.kernel},{self.device},{self.t1_s*1e6:.3f},"
                f"{self.t3_baseline_s*1e6:.1f},{self.t3_halo_s*1e6:.1f},"
                f"{self.t3_agnostic_s*1e6:.1f},{self.halo_score:.4f},"
                f"{self.agnostic_score:.2e},{self.halo_gain:.1f},"
                f"{self.overhead*100:.5f}%")

    @staticmethod
    def csv_header() -> str:
        return ("kernel,device,T1_us,T3_base_us,T3_halo_us,T3_agnostic_us,"
                "halo_score,agnostic_score,halo_gain_x,overhead_ratio")


@dataclasses.dataclass
class ServeReport:
    """Serving-path scorecard: the paper's T-term decomposition applied to
    the slot engine's iteration loop.

    T1 = host orchestration (admission bookkeeping, slot retirement, mask
    assembly), T3 = blocked device time (prefill-into-slot and the batched
    decode step, each ending when its sampled tokens reach the host), T2 ≈
    0 (the slot cache stays on the device).  ``overhead`` is T1/T4."""

    t1_s: float
    t3_s: float
    steps: int
    tokens: int

    @property
    def t4_s(self) -> float:
        return self.t1_s + self.t3_s

    @property
    def overhead(self) -> float:
        return overhead_ratio(self.t1_s, self.t4_s)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.t4_s if self.t4_s > 0 else 0.0

    def csv(self) -> str:
        return (f"serve,{self.steps},{self.tokens},{self.t1_s * 1e6:.1f},"
                f"{self.t3_s * 1e6:.1f},{self.tokens_per_s:.1f},"
                f"{self.overhead * 100:.4f}%")

    @staticmethod
    def csv_header() -> str:
        return "path,steps,tokens,T1_us,T3_us,tok_per_s,overhead_ratio"
