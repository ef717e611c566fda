"""Quickstart: the paper's hardware-agnostic host template (Table V) for the
ported aliases — MMM, EWMM, EWMD, EWADD, EWSUB, MVM and VDP.

The same host code — claim by alias, send a compute-object, receive the
result — runs every alias with no hardware-specific logic; the runtime
agent routes each request to the best feasible record (hopper > aten >
torch fail-safe).  It runs once blocking (send/recv) and once as a
non-blocking burst (isend/waitall).  Port of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--n N]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from . import halo

#: the aliases the quickstart drives, in order
ALIASES = ("MMM", "EWMM", "EWMD", "EWADD", "EWSUB", "MVM", "VDP")


def make_jobs(sizes: Mapping[str, int], device, seed: int = 0
              ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Random float32 inputs for every alias, made on ``device`` from
    ``seed``.

    ``sizes`` gives the edge per family: ``"MMM"`` (n×n @ n×n), ``"EW"``
    (n×n operands; the divisor is shifted by +3 away from 0), ``"MVM"``
    (n×n @ n) and ``"VDP"`` (two length-n vectors of mean 1, so Σxy grows
    like n and a relative error of the result means something)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    n_mmm, n_ew, n_mvm, n_vdp = (sizes[k] for k in ("MMM", "EW", "MVM", "VDP"))
    a_mmm, b_mmm = normal(n_mmm, n_mmm), normal(n_mmm, n_mmm)
    a_ew, b_ew = normal(n_ew, n_ew), normal(n_ew, n_ew) + 3.0
    a_mvm, x_mvm = normal(n_mvm, n_mvm), normal(n_mvm)
    x_vdp, y_vdp = normal(n_vdp) + 1.0, normal(n_vdp) + 1.0
    return {
        "MMM": (a_mmm, b_mmm),
        "EWMM": (a_ew, b_ew),
        "EWMD": (a_ew, b_ew),
        "EWADD": (a_ew, b_ew),
        "EWSUB": (a_ew, b_ew),
        "MVM": (a_mvm, x_mvm),
        "VDP": (x_vdp, y_vdp),
    }


def run(jobs: Mapping[str, Tuple[Any, ...]],
        overrides: Optional[Dict[str, Any]] = None
        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The host template over ``jobs`` (alias -> argument tuple) on the live
    session: blocking claim/send/recv per alias, then every alias at once
    through isend/waitall.  ``overrides`` go to every claim (for example
    ``{"allowed_platforms": ["hopper"]}``).  Returns ``(sync, async)``
    results keyed by alias, both device-ready."""
    sync: Dict[str, Any] = {}
    for alias, args in jobs.items():
        cr = halo.claim(alias, overrides=overrides)     # claim a child rank
        halo.send(args, cr)                             # marshal compute-obj
        sync[alias] = halo.recv(cr)                     # retrieve result
        halo.free(cr)
    # non-blocking variant: submit everything, then wait (DESIGN.md §4)
    crs, reqs = [], []
    for alias, args in jobs.items():
        cr = halo.claim(alias, overrides=overrides)
        crs.append(cr)
        # mailbox=False: consumed through the handles, never via halo.recv
        reqs.append(halo.isend(args, cr, mailbox=False))
    outs: List[Any] = halo.waitall(reqs)
    for cr in crs:
        halo.free(cr)
    return sync, dict(zip(jobs, outs))


def main(argv=None) -> None:
    """Command-line entry: run the template once and print what came out."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; needs an H100) or cpu")
    p.add_argument("--n", type=int, default=512, help="edge of every input")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    session = halo.initialize(device=args.device)
    sizes = {"MMM": args.n, "EW": args.n, "MVM": args.n, "VDP": args.n}
    jobs = make_jobs(sizes, session.device, seed=args.seed)
    sync, asyn = run(jobs)
    for alias, out in sync.items():
        print(f"{alias:6s} -> shape {tuple(out.shape)} {out.dtype} "
              f"finite={bool(torch.isfinite(out).all())}")
    ok = all(bool(torch.isfinite(o).all()) for o in asyn.values())
    print(f"\nasync burst: {len(asyn)} subroutines in flight at once, "
          f"all finite={ok}")
    print(f"HALO overhead T1 per call: "
          f"{session.t1_seconds_per_call * 1e6:.1f} us on {session.device}")
    halo.finalize()


if __name__ == "__main__":
    main()
