"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
— port of ``repro.launch.train``.

Trains a configuration on the synthetic LM stream through the Trainer:
the forward and backward on the card's kernels (``--device cuda``, the
default, which needs an H100) or, with ``--device cpu``, on their plain
versions; checkpoints, heartbeat and the straggler policy as in the
reference; a resumed run goes on after the checkpointed step.  ``--comm
N`` trains data-parallel over an N-member C²MPI device group cycling the
session's available substrates, with ``--microbatches`` raised to a
multiple of N.

``--mesh debug|single|multi`` trains under the reference's mesh: (2, 2),
(16, 16) or (2, 16, 16), one process a rank started by
``launch.mesh.run_ranks``, each running the same training inside
``mesh_context`` (the global view: the MoE layers' ``shard_map`` bodies
and their backward exchange over the mesh, every rank makes the same
update; rank 0 alone logs, beats and writes checkpoints).  The ranks
join over ``gloo`` where they share a device (the CPU, or fewer cards
than ranks: the debug mesh on one card) and over ``nccl`` where each has
a card of its own; a line says which.  The production meshes take one
card a rank and raise on a machine with fewer, as ``make_mesh`` does.
With ``--comm N`` too, each rank trains over its own device group inside
the mesh, as the reference does with both.  The launcher returns rank 0's
history and raises if any rank's differs.
"""
from __future__ import annotations

import argparse
import logging
import math

import torch

from .. import halo
from ..configs import get_config
from ..core.agents import require_hopper
from ..data.pipeline import SyntheticLM
from ..distributed.sharding import mesh_context
from ..models import build_model
from ..train.checkpoint import CheckpointManager
from ..train.fault_tolerance import HeartbeatJournal, StragglerPolicy
from ..train.trainer import TrainHyper, Trainer
from .mesh import NAMED_MESHES, make_mesh, run_ranks

#: seconds ``run_ranks`` gives the ranks' whole run, collectives included
MESH_TIMEOUT_S = 86400.0


def _train(args, mesh_kind: str = "none"):
    """The training run in this process (one rank of a mesh, or alone)."""
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

        mesh = None if mesh_kind == "none" else make_mesh(*NAMED_MESHES[mesh_kind])
        with mesh_context(mesh):
            gen = torch.Generator(device=session.device).manual_seed(args.seed)
            state, _ = trainer.restore_or_init(gen)
            # a checkpoint of step s holds s's update: go on at s + 1, the
            # optimizer's step count (the reference starts again at s)
            start = int(state.opt.step)
            state, history = trainer.run(state, data_fn,
                                         steps=max(0, args.steps - start),
                                         start_step=start)
    finally:
        halo.finalize()
    return history


def _train_on_mesh(args):
    """Every rank's history, ``--mesh``'s ranks started by ``run_ranks``."""
    shape = NAMED_MESHES[args.mesh][0]
    world = math.prod(shape)
    on_cpu = torch.device(args.device).type == "cpu"
    if not on_cpu:
        require_hopper(torch.device(args.device))
    cards = 0 if on_cpu else torch.cuda.device_count()
    if args.mesh != "debug" and cards < world:
        raise ValueError(f"--mesh {args.mesh}: a mesh of {shape} takes {world} "
                         f"ranks, one a card; this machine has {cards} cards")
    backend = "nccl" if cards >= world else "gloo"
    where = ("one card a rank" if backend == "nccl" else
             "the ranks share the CPU" if on_cpu else
             f"{world} ranks share {cards} card(s)")
    print(f"mesh {args.mesh} {shape}: {world} ranks over {backend} ({where})",
          flush=True)
    histories = run_ranks(_train, world, backend=backend, timeout=MESH_TIMEOUT_S,
                          args=(args, args.mesh),
                          device_type="cpu" if on_cpu else "cuda")
    differ = [r for r, h in enumerate(histories) if h != histories[0]]
    if differ:
        raise RuntimeError(f"ranks {differ} trained another history than rank 0: "
                           f"{histories}")
    return histories[0]


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
                    default="none", help="train under the reference's mesh, "
                    "one process a rank: debug (2, 2), single (16, 16), multi "
                    "(2, 16, 16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (an H100; raises without one) or cpu")
    args = ap.parse_args(argv)
    history = _train(args) if args.mesh == "none" else _train_on_mesh(args)
    print("final loss:", history[-1][1] if history else None)
    return history


if __name__ == "__main__":
    main()
