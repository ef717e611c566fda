"""Mixed in-process/remote Jacobi: the DESIGN.md §13 multi-process runtime —
port of ``examples/multiproc_jacobi.py``.

The host program of ``collective_jacobi.py`` runs over a device group whose
members span OS processes: rank 0 is the in-process ``hopper`` agent, ranks
1..R are :class:`~repro_torch.distributed.remote.RemoteAgent` proxies for
the ``hopper`` substrate of spawned worker processes on the same device.
Attaching a worker republishes the hopper records under ``hopper@<name>``,
so ``comm_split(["hopper", "hopper@w0", ...])`` is the *only* line that
changes — the collective verbs, graph capture, scheduling and failover are
untouched, and the iterate is **bit-identical** to serial hopper: every
member runs the same kernels on the same device, MVM sums each row alone
and the updates are element-wise.

The template then kills one worker mid-solve (its MVM wedged by a fault
plan, so the kill lands on a request in flight): the transport EOF drives
the dead-agent ladder (mark dead -> deregister the member's records ->
comm re-bind -> replay on the survivors).  On the CPU every row is plain,
so the result stays bit-identical; on the card the replayed member-pinned
nodes run on the plain torch rows, whose MVM sums in another order, and
the iterate is held to a tolerance instead.

Run:  PYTHONPATH=src python -m repro_torch.multiproc_jacobi [--device cpu]
      [--n N] [--iters K] [--workers R]
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Callable, Sequence, Tuple

import torch

from . import halo
from .collective_jacobi import (collective_jacobi, collective_jacobi_graph,
                                problem, serial_jacobi, solve_error)

#: the kill drill's iterate against serial hopper on the card, normwise (the
#: replayed rows' plain MVM sums in another order than mvm.cu: float32
#: rounding, as phase 3g holds its member death to)
KILL_TOL = 1e-5


def kill_mid_solve(worker, solve: Callable[[], Tuple], nth: int = 2,
                   timeout: float = 60.0):
    """Run ``solve()`` while ``worker`` dies mid-solve: its hopper MVM
    wedges on the ``nth`` call (``FaultPlan(mode="die")`` inside the
    worker), a killer thread waits until the worker reports that call
    wedged (the plan's failure count in its ``ping`` reply), then kills
    the process.  Returns (solve's result, ms from the kill to the
    member's agent being DEAD)."""
    agent = worker.agent("hopper")
    worker.chaos(platform="hopper", mode="die", aliases=["MVM"], nth=nth)
    out = {}

    def wedged() -> bool:
        try:
            plan = worker.heartbeat(timeout=timeout)["chaos"].get("hopper", {})
        except (RuntimeError, TimeoutError):   # the transport is gone
            return True
        return plan.get("failures", 0) >= 1

    def killer():
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not wedged():
            time.sleep(0.005)
        t0 = time.perf_counter()
        worker.kill()
        while not agent.dead and time.perf_counter() - t0 < timeout:
            time.sleep(0.0005)
        out["dead_ms"] = (time.perf_counter() - t0) * 1e3

    t = threading.Thread(target=killer, daemon=True)
    t.start()
    try:
        result = solve()
    finally:
        t.join(timeout=timeout)
    if not agent.dead:
        raise RuntimeError(f"worker {worker.name} was never declared dead")
    return result, out["dead_ms"]


def main(argv: Sequence[str] = None) -> None:
    """Command-line entry: serial hopper, then eager and graph over the
    mixed group (bit-identical to serial), then the kill drill."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; needs an H100) or cpu")
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    session = halo.initialize(device=args.device)
    device = session.device.type
    a, b, d = problem(args.n, session.device, args.seed)
    x_ref, res_ref = serial_jacobi(a, b, d, args.iters, "hopper")

    from .distributed.remote import spawn_worker
    workers = []
    try:
        for i in range(args.workers):
            workers.append(spawn_worker(f"w{i}", device=device))
        members = ["hopper"] + [w.agent("hopper").attach(session).platform
                                for w in workers]
        print(f"workers up: {[w.name for w in workers]}; device group "
              f"members: {members} on {session.device}")
        comm = halo.comm_split(members)
        x_mix, res_mix = collective_jacobi(comm, a, b, d, args.iters)
        _, x_graph, res_graph = collective_jacobi_graph(comm, a, b, d,
                                                        args.iters)
        comm.free()
        same = torch.equal(x_mix, x_ref) and torch.equal(x_graph, x_mix) \
            and res_graph == res_mix
        print(f"{len(members)}-rank mixed comm, eager and graph, == serial "
              f"hopper bit for bit: {same}; residual {res_mix:.3e} (serial "
              f"{res_ref:.3e})")
        for w in workers:
            print(f"  {w.name}: wire {w.client.wire_stats()}")
        if not same:
            raise SystemExit("the mixed group differs from serial hopper")

        victim = workers[-1]
        comm = halo.comm_split(members)
        (x_kill, _), dead_ms = kill_mid_solve(
            victim, lambda: collective_jacobi(comm, a, b, d, args.iters))
        comm.free()
        if device == "cpu":
            ok, how = torch.equal(x_kill, x_ref), "bit-identical"
        else:
            err = float(torch.linalg.vector_norm(x_kill - x_ref)
                        / torch.linalg.vector_norm(x_ref))
            ok, how = err <= KILL_TOL, f"{err:.2e} normwise from serial"
        print(f"worker {victim.name} killed mid-solve: DEAD after "
              f"{dead_ms:.1f} ms; the replay on the survivors left the "
              f"iterate {how}; solve error {solve_error(a, b, x_kill):.2e}")
        if not ok:
            raise SystemExit("the kill drill's iterate differs")
    finally:
        for w in workers:
            if w.dead:
                w.kill()
            else:
                w.shutdown()
        halo.finalize()
    print("OK")


if __name__ == "__main__":
    main()
