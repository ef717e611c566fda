"""Autotune CLI: sweep the Hopper kernels' launch plans on the card —
port of ``repro.launch.tune``.

Sweeps every feasible ``alias × record × shape-bucket`` combination whose
record declares a tuning space (DESIGN.md §9: MMM's route, split count and
tile width, EW*'s items a thread, RMSNORM's warps a row, SORT's rows a
block), committing winners into a persistent
:class:`~repro_torch.core.tuning.TuningDB`:

    PYTHONPATH=src python -m repro_torch.launch.tune --report   # full sweep
    PYTHONPATH=src python -m repro_torch.launch.tune --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.tune --no-sweep --report
    PYTHONPATH=src python -m repro_torch.launch.tune --aliases MMM --repeats 5

The DB path resolves ``--db`` → ``HALO_TUNING_DB`` → the
``HALO_AUTOTUNE_CACHE`` sibling → ``halo_tuning.json`` in the working
directory; a program run with ``HALO_TUNING_DB`` pointing at it takes the
winners with no change of its own.  Entries are frozen after a sweep; pass
``--force`` to re-sweep committed buckets.  The sweep runs on the card
(``--device cuda``, the default, which needs an H100); ``--device cpu``
drives the same protocol over the plain versions, where the times mean
nothing.  ``--smoke`` keeps shapes tiny and repeats low.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.tuning import TuneResult, TuningDB, autotune

#: builds one bucket's arguments on a device from a seed
Builder = Callable[[torch.device, int], Tuple]


def _rand(dev: torch.device, seed: int, shape, dtype=torch.float32,
          shift: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """Normal values from a numpy seed, placed on ``dev`` in ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return (torch.from_numpy(x * scale + shift)).to(device=dev, dtype=dtype)


def _mk_mmm(m: int, k: int, n: int, dtype=torch.bfloat16) -> Builder:
    return lambda dev, seed: (_rand(dev, seed, (m, k), dtype),
                              _rand(dev, seed + 1, (k, n), dtype, scale=k ** -0.5))


def _mk_ewise(m: int, n: int, dtype=torch.float32) -> Builder:
    # the divisor away from 0, as the reference's sweep builds it
    return lambda dev, seed: (_rand(dev, seed, (m, n), dtype),
                              _rand(dev, seed + 1, (m, n), dtype, shift=3.0))


def _mk_rmsnorm(shape: Tuple[int, ...], dtype=torch.bfloat16) -> Builder:
    return lambda dev, seed: (_rand(dev, seed, shape, dtype),
                              _rand(dev, seed + 1, shape[-1:], dtype, shift=1.0,
                                    scale=0.1))


def _mk_sort(rows: int, n: int, dtype=torch.float32) -> Builder:
    return lambda dev, seed: (_rand(dev, seed, (rows, n), dtype),)


#: h2o-danube-1.8b's projections (d_model 2560, 8 KV heads of 80, d_ff
#: 6912): (K, N) of q/o, k/v, gate/up, down
DANUBE_PROJECTIONS = ((2560, 2560), (2560, 640), (2560, 6912), (6912, 2560))
#: its unembed (d_model × vocab)
DANUBE_UNEMBED = (2560, 32000)

#: alias → arg builders, one per shape bucket, at the card's real sizes:
#: danube's decode step (4 rows, its slots) and prefill (512 rows) in
#: bfloat16 and the decode unembed; the template's EW* at 8192² float32;
#: RMSNORM over 4, 512 and 4096 rows of d_model, the first two laid out as
#: the model dispatches them (a decode step's 4 slots × 1 token, one
#: 512-token prefill), the last as 2-D rows; SORT's tile route at 4096 rows
#: of 4096
SHAPES: Dict[str, List[Builder]] = {
    "MMM": [_mk_mmm(m, k, n) for m in (4, 512) for k, n in DANUBE_PROJECTIONS]
    + [_mk_mmm(4, *DANUBE_UNEMBED)],
    "EWMM": [_mk_ewise(8192, 8192)],
    "EWMD": [_mk_ewise(8192, 8192)],
    "EWADD": [_mk_ewise(8192, 8192)],
    "EWSUB": [_mk_ewise(8192, 8192)],
    "RMSNORM": [_mk_rmsnorm(shape) for shape in ((4, 1, 2560), (1, 512, 2560),
                                                 (4096, 2560))],
    "SORT": [_mk_sort(4096, 4096)],
}

#: --smoke: tiny buckets (both MMM sides of SKINNY_M_MAX) for a CPU run
SMOKE_SHAPES: Dict[str, List[Builder]] = {
    "MMM": [_mk_mmm(4, 80, 72), _mk_mmm(96, 80, 72)],
    "EWMM": [_mk_ewise(64, 160)],
    "EWMD": [_mk_ewise(64, 160)],
    "RMSNORM": [_mk_rmsnorm((48, 256))],
    "SORT": [_mk_sort(8, 100)],
}


def _default_db_path(explicit: str | None) -> Path:
    """--db → :meth:`TuningDB.default`'s env resolution → cwd default."""
    if explicit:
        return Path(explicit)
    return TuningDB.default().path or Path("halo_tuning.json")


def report(db: TuningDB, out=sys.stdout) -> int:
    """Print the DB as an aligned table; returns the number of rows."""
    rows = [("key", "config", "tuned_us", "default_us", "gain_x")]
    for key, ent in sorted(db.entries().items()):
        cfg = ",".join(f"{k}={v}" for k, v in sorted(ent.config.items())) \
            or "(default)"
        rows.append((key, cfg, f"{ent.seconds*1e6:.1f}",
                     f"{ent.default_seconds*1e6:.1f}",
                     f"{ent.speedup:.2f}"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)), file=out)
    return len(rows) - 1


def sweep(db: TuningDB, aliases: Sequence[str], *, smoke: bool = False,
          repeats: int = 3, warmup: int = 1, force: bool = False,
          verbose: bool = True, device="cuda", seed: int = 0) -> List[TuneResult]:
    """Sweep all feasible record × shape-bucket combos for ``aliases`` on
    ``device``.

    Returns one :class:`TuneResult` per bucket visited (``swept`` False for
    a frozen entry; the reference returns their count).  Records without a
    tuning space, records infeasible for the sample shape, and platforms
    without a live agent are skipped.  The i-th bucket of an alias builds
    its inputs from ``seed + 2 i``."""
    from .. import kernels
    from ..core.agents import RuntimeAgent
    from ..core.manifest import default_manifest
    from ..core.registry import GLOBAL_REGISTRY

    kernels.register_all()
    # a throwaway session tells us which platforms have live agents here
    session = RuntimeAgent(manifest=default_manifest(), scheduler=False,
                           device=device)
    live = set(session._allowed_platforms())
    shapes = SMOKE_SHAPES if smoke else SHAPES
    results: List[TuneResult] = []
    try:
        for alias in aliases:
            for i, build in enumerate(shapes.get(alias, ())):
                args = build(session.device, seed + 2 * i)
                for rec in GLOBAL_REGISTRY.records(alias):
                    if rec.tuning_space is None or rec.platform not in live:
                        continue
                    if not rec.feasible(*args) or not rec.variants(*args):
                        continue
                    t0 = time.perf_counter()
                    res = autotune(rec, args, db=db, repeats=repeats,
                                   warmup=warmup, force=force)
                    if verbose:
                        state = (f"swept {len(res.timings)} variants in "
                                 f"{time.perf_counter() - t0:.1f}s"
                                 if res.swept else "frozen (skipped)")
                        cfg = res.entry.config or "(default)"
                        print(f"{res.key}: {state} → {cfg} "
                              f"[{res.entry.seconds*1e6:.0f}us, "
                              f"{res.entry.speedup:.2f}x vs default]",
                              flush=True)
                    results.append(res)
                del args
    finally:
        session.finalize()
    return results


def main(argv: Sequence[str] | None = None) -> int:
    """Entry point for ``python -m repro_torch.launch.tune``; returns the
    exit code."""
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.tune",
        description="Sweep the kernels' launch plans and persist the TuningDB.")
    p.add_argument("--db", default=None, help="TuningDB path (default: "
                   "HALO_TUNING_DB, HALO_AUTOTUNE_CACHE sibling, or "
                   "./halo_tuning.json)")
    p.add_argument("--aliases", default=None,
                   help="comma-separated alias filter (default: all tunable)")
    p.add_argument("--repeats", type=int, default=3,
                   help="best-of-N samples per variant")
    p.add_argument("--warmup", type=int, default=1,
                   help="discarded leading samples per variant")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes + repeats=2")
    p.add_argument("--force", action="store_true",
                   help="re-sweep buckets with frozen entries")
    p.add_argument("--report", action="store_true",
                   help="print the DB as a table after sweeping "
                   "(alone: just print and exit)")
    p.add_argument("--no-sweep", action="store_true",
                   help="skip sweeping (use with --report)")
    p.add_argument("--device", default="cuda",
                   help="cuda (an H100, the default) or cpu (the plain "
                   "versions: the protocol, not the times)")
    args = p.parse_args(argv)

    path = _default_db_path(args.db)
    db = TuningDB(path)
    if args.no_sweep:
        report(db)
        return 0
    aliases = (args.aliases.split(",") if args.aliases
               else sorted(SMOKE_SHAPES if args.smoke else SHAPES))
    repeats = 2 if args.smoke and args.repeats == 3 else args.repeats
    results = sweep(db, aliases, smoke=args.smoke, repeats=repeats,
                    warmup=args.warmup, force=args.force, device=args.device)
    saved = db.save(path)
    n = sum(r.swept for r in results)
    print(f"swept {n} bucket(s); {len(db)} entr(y/ies) in {saved or path}")
    if args.report:
        report(db)
    return 0


if __name__ == "__main__":
    sys.exit(main())
