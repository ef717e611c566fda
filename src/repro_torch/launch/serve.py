"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
— port of ``repro.launch.serve``.

Slot-based continuous batching: a StepScheduler admits requests into a
fixed pool of decode slots, each request retires independently on its own
EOS / ``max_new``, and the run reports throughput, per-request latency
percentiles and the serving T1/T3 scorecard.  ``--legacy`` routes the same
workload through the whole-batch RequestQueue instead; ``--paged`` serves
it from the paged KV cache (refcounted block arena, COW prefix sharing,
chunked prefill: ``--block-size``, ``--num-blocks``, ``--chunk``) and
reports the allocator scorecard.  The model runs on the card (``--device
cuda``, the default, which needs an H100) or, with ``--device cpu``, on
the plain versions of its kernels.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .. import halo
from ..configs import get_config
from ..core.portability import ServeReport, percentile_nearest
from ..models import build_model
from ..serve.engine import (PagedEngine, RequestQueue, ServeEngine,
                            SlotEngine, StepScheduler)


def mixed_budgets(requests: int, max_new: int) -> List[int]:
    """Mixed decode budgets: slot lanes retire independently."""
    return [max(1, max_new - (i % 4) * (max_new // 4)) for i in range(requests)]


def run_requests(sched, prompts: Sequence[Sequence[int]],
                 max_news: Sequence[int]) -> Tuple[list, List[float], float]:
    """Submit every request to ``sched`` (a StepScheduler or a
    RequestQueue, started for the run) and wait for all; returns (results,
    sorted request latencies in s, wall in s)."""
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
            report: Optional[ServeReport]) -> List[str]:
    """The launcher's report lines (the T1/T3 scorecard when a scheduler's
    ``report`` is given)."""
    toks = sum(len(r) for r in results)
    lines = [f"served {len(results)} requests, {toks} tokens in {dt:.2f}s "
             f"({toks / dt:.1f} tok/s)",
             f"request latency p50={percentile_nearest(lat, .5) * 1e3:.0f}ms "
             f"p95={percentile_nearest(lat, .95) * 1e3:.0f}ms"]
    if report is not None:
        lines += [ServeReport.csv_header(), report.csv()]
    return lines


def arena_line(stats) -> str:
    """The paged engine's allocator scorecard line."""
    return (f"paged arena: capacity={stats['capacity']} "
            f"hit_rate={stats['prefix_hit_rate']:.3f} "
            f"blocks_per_token={stats['blocks_per_token']:.3f} "
            f"forks={stats['forks']} evictions={stats['evictions']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-slot pool size (legacy: batch size)")
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
                    help="whole-batch RequestQueue path")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: refcounted block arena, COW "
                         "prefix sharing, chunked prefill")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (--paged)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="arena capacity in blocks (--paged; default: "
                         "dense-parity capacity)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="prefill chunk length in tokens (--paged; 0 = "
                         "whole-prompt admission)")
    args = ap.parse_args(argv)
    if args.legacy and args.paged:
        ap.error("--legacy and --paged are mutually exclusive")

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
        paged = None
        if args.legacy:
            front = RequestQueue(ServeEngine(model, max_len=max_len), params,
                                 args.slots, args.prompt_len,
                                 temperature=args.temperature)
        else:
            if args.paged:
                engine = paged = PagedEngine(
                    model, params, args.slots, max_len,
                    block_size=args.block_size, num_blocks=args.num_blocks,
                    chunk_tokens=args.chunk)
            else:
                engine = SlotEngine(model, params, args.slots, max_len)
            front = StepScheduler(engine, temperature=args.temperature,
                                  seed=args.seed)
        results, lat, dt = run_requests(
            front, prompts, mixed_budgets(args.requests, args.max_new))
        report = None if args.legacy else front.report()
        for line in summary(results, lat, dt, report):
            print(line)
        if paged is not None:
            print(arena_line(paged.stats()))
        for i, r in enumerate(results[:3]):
            print(f"  req {i + 1}: {r[:8]}…")
        return results
    finally:
        halo.finalize()


if __name__ == "__main__":
    main()
