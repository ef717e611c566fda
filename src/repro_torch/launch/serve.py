"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
— port of ``repro.launch.serve``'s slot path.

Slot-based continuous batching: a StepScheduler admits requests into a
fixed pool of decode slots, each request retires independently on its own
EOS / ``max_new``, and the run reports throughput, per-request latency
percentiles and the serving T1/T3 scorecard.  The model runs on the card
(``--device cuda``, the default, which needs an H100) or, with
``--device cpu``, on the plain versions of its kernels.  ``--legacy`` and
``--paged`` are not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Sequence, Tuple

import torch

from .. import halo
from ..configs import get_config
from ..core.portability import ServeReport, percentile_nearest
from ..models import build_model
from ..serve.engine import SlotEngine, StepScheduler


def mixed_budgets(requests: int, max_new: int) -> List[int]:
    """Mixed decode budgets: slot lanes retire independently."""
    return [max(1, max_new - (i % 4) * (max_new // 4)) for i in range(requests)]


def run_requests(sched: StepScheduler, prompts: Sequence[Sequence[int]],
                 max_news: Sequence[int]) -> Tuple[list, List[float], float]:
    """Submit every request to ``sched`` (started for the run) and wait for
    all; returns (results, sorted request latencies in s, wall in s)."""
    lat: List[float] = []
    t0 = time.perf_counter()
    with sched:
        futs = []
        for p, n in zip(prompts, max_news):
            ts = time.perf_counter()
            fut = sched.submit(p, max_new=n)
            fut.add_done_callback(
                lambda f, ts=ts: lat.append(time.perf_counter() - ts))
            futs.append(fut)
        results = [f.result() for f in futs]
    dt = time.perf_counter() - t0
    # done-callbacks may trail the last result(); wait before aggregating
    deadline = time.perf_counter() + 5.0
    while len(lat) < len(futs) and time.perf_counter() < deadline:
        time.sleep(0.001)
    return results, sorted(lat), dt


def summary(results, lat: List[float], dt: float,
            report: ServeReport) -> List[str]:
    """The launcher's report lines."""
    toks = sum(len(r) for r in results)
    return [f"served {len(results)} requests, {toks} tokens in {dt:.2f}s "
            f"({toks / dt:.1f} tok/s)",
            f"request latency p50={percentile_nearest(lat, .5) * 1e3:.0f}ms "
            f"p95={percentile_nearest(lat, .95) * 1e3:.0f}ms",
            ServeReport.csv_header(), report.csv()]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4, help="decode-slot pool size")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16,
                    help="largest per-request decode budget (the workload "
                         "mixes shorter ones in)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (an H100; raises without one) or cpu")
    ap.add_argument("--legacy", action="store_true",
                    help="whole-batch RequestQueue path (not ported yet)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (not ported yet)")
    args = ap.parse_args(argv)
    if args.legacy or args.paged:
        ap.error("--legacy and --paged are not ported yet (ROADMAP A7)")

    session = halo.initialize(device=args.device)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = build_model(cfg)
        gen = torch.Generator(device=session.device).manual_seed(args.seed)
        params = model.init(gen)
        max_len = args.prompt_len + args.max_new + cfg.prefix_len + 8
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.requests, args.prompt_len), generator=gen,
                                device=session.device).tolist()
        sched = StepScheduler(SlotEngine(model, params, args.slots, max_len),
                              temperature=args.temperature, seed=args.seed)
        results, lat, dt = run_requests(
            sched, prompts, mixed_budgets(args.requests, args.max_new))
        for line in summary(results, lat, dt, sched.report()):
            print(line)
        for i, r in enumerate(results[:3]):
            print(f"  req {i + 1}: {r[:8]}…")
        return results
    finally:
        halo.finalize()


if __name__ == "__main__":
    main()
