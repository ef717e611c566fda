"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
— port of ``repro.launch.train``.

Trains a configuration on the synthetic LM stream through the Trainer:
the forward and backward on the card's kernels (``--device cuda``, the
default, which needs an H100) or, with ``--device cpu``, on their plain
versions; checkpoints, heartbeat and the straggler policy as in the
reference; a resumed run goes on after the checkpointed step.  ``--comm
N`` trains data-parallel over an N-member C²MPI device group cycling the
session's available substrates, with ``--microbatches`` raised to a
multiple of N.  A device mesh (``--mesh`` other than ``none``) raises:
serving runs under a mesh (``repro_torch.launch.mesh``), training under a
mesh — the backward through the collectives, the Trainer's shardings —
is ROADMAP A10c's training part.
"""
from __future__ import annotations

import argparse
import logging

import torch

from .. import halo
from ..configs import get_config
from ..data.pipeline import SyntheticLM
from ..models import build_model
from ..train.checkpoint import CheckpointManager
from ..train.fault_tolerance import HeartbeatJournal, StragglerPolicy
from ..train.trainer import TrainHyper, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--comm", type=int, default=0, metavar="N",
                    help="train data-parallel over an N-member C²MPI device "
                         "group (cycling the available substrates); "
                         "microbatches is raised to a multiple of N")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--mesh", choices=["none", "debug", "single", "multi"],
                    default="none", help="a device mesh other than none: "
                    "training under a mesh is not ported (ROADMAP A10c)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (an H100; raises without one) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise ValueError(f"--mesh {args.mesh}: training under a mesh (the "
                         f"backward through the collectives, the Trainer's "
                         f"shardings) is not ported yet: ROADMAP A10c")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    session = halo.initialize(device=args.device)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = build_model(cfg)
        comm = None
        microbatches = args.microbatches
        if args.comm:
            subs = session.comm_split().platforms    # available substrates
            comm = session.comm_split(
                [subs[i % len(subs)] for i in range(args.comm)])
            microbatches = -(-microbatches // args.comm) * args.comm
        hp = TrainHyper(base_lr=args.lr, warmup_steps=max(1, args.steps // 10),
                        total_steps=args.steps, microbatches=microbatches,
                        compress_grads=args.compress_grads)
        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        hb = HeartbeatJournal(args.heartbeat) if args.heartbeat else None
        trainer = Trainer(model=model, hp=hp, ckpt=ckpt, heartbeat=hb,
                          straggler=StragglerPolicy(), comm=comm, arch=args.arch,
                          arch_reduced=args.reduced)
        pipe = SyntheticLM(cfg, seq_len=args.seq_len, global_batch=args.batch,
                           seed=args.seed)

        def data_fn(step):
            return pipe.device_batch(step, session.device)

        gen = torch.Generator(device=session.device).manual_seed(args.seed)
        state, _ = trainer.restore_or_init(gen)
        # a checkpoint of step s holds s's update: go on at s + 1, the
        # optimizer's step count (the reference starts again at s)
        start = int(state.opt.step)
        state, history = trainer.run(state, data_fn, steps=max(0, args.steps - start),
                                     start_step=start)
    finally:
        halo.finalize()
    print("final loss:", history[-1][1] if history else None)
    return history


if __name__ == "__main__":
    main()
