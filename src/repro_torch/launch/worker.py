"""Remote worker entry point: ``python -m repro_torch.launch.worker
--connect HOST:PORT [--name w0] [--platforms hopper,aten,torch]
[--device cuda|cpu]`` — port of ``repro.launch.worker``.

Spawned by :func:`repro_torch.distributed.remote.spawn_worker`.  The
worker dials back to the host, builds its own HALO session on ``--device``
(the card by default: it raises without a capability-9.0 card, and builds
or loads the kernel library before it reads the host's hello), and serves
``hello``/``exec``/``ping``/``chaos``/``release``/``shutdown`` frames
until the transport closes (DESIGN.md §13).  The heavy imports happen
inside :func:`main` so ``--help`` and argument errors stay instant.  The
reference's ``--devices`` (XLA's host-device fan-out) has no torch
counterpart and is not taken.
"""
from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="host-side listener to dial back to")
    ap.add_argument("--name", default="w0")
    ap.add_argument("--platforms", default="hopper,aten,torch",
                    help="comma-separated substrates this worker serves")
    ap.add_argument("--device", default="cuda",
                    help="cuda (an H100; raises without one) or cpu")
    ap.add_argument("--log-level", default=None)
    args = ap.parse_args(argv)
    from ..core.config import halo_config
    if args.log_level is None:
        args.log_level = halo_config().worker_log
    logging.basicConfig(
        level=args.log_level.upper(),
        format=f"[{args.name}] %(levelname)s %(name)s: %(message)s")

    from ..distributed.remote import connect_and_serve
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    connect_and_serve(args.connect, name=args.name, platforms=platforms,
                      device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
