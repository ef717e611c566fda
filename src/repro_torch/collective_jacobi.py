"""Data-parallel Jacobi over a C²MPI device group (DESIGN.md §10) — port of
``examples/collective_jacobi.py``.

The paper's Jacobi subroutine distributed over a ``HaloComm``: the rows of
the system are scattered across the member ranks, each member sweeps its
row shard (``MVM`` and the element-wise updates pinned to its agent), the
members exchange the iterate with an allgather, and convergence is checked
with an **allreduce** of the per-member partial residuals — the
reduce/broadcast pattern point-to-point verbs cannot express.

The same host program runs three ways:

* **serial**  — one agent, one kernel at a time, every dispatch pinned to
  one substrate;
* **eager**   — blocking collective verbs;
* **graph**   — the whole iteration loop captured into one execution graph
  (collectives become multi-parent DAG nodes; reduce combines are placed
  per node among the members).

On one substrate the collective iterate equals the serial one bit for bit:
MVM sums each row alone and the updates are element-wise, so sharding the
rows changes no bit; only the residual's VDP partial sums are bracketed
differently.

Run:  PYTHONPATH=src python -m repro_torch.collective_jacobi [--device cpu]
      [--n N] [--iters K] [--group hopper,hopper,hopper,hopper]
"""
from __future__ import annotations

import argparse
import time

import torch

from . import halo
from .core.portability import portability_score


def _pin(platform: str):
    return {"allowed_platforms": [platform],
            "platform_preference": [platform]}


def problem(n: int, device, seed: int = 0):
    """A diagonally dominant float32 system on ``device`` from ``seed``:
    A = N(0, 1) + n·I, b = N(0, 1), and A's diagonal d."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((n, n), generator=gen, device=device)
    a.diagonal().add_(float(n))
    b = torch.randn((n,), generator=gen, device=device)
    return a, b, a.diagonal().clone()


def serial_jacobi(a, b, d, iters: int, platform: str = "hopper"):
    """Single-agent serial reference: x ← (b − A·x + d⊙x) ⊘ d, one kernel
    dispatch at a time, every dispatch pinned to ``platform``.  Returns the
    iterate and the last sweep's ‖x_new − x‖²."""
    ov = _pin(platform)
    x = torch.zeros_like(b)
    res = torch.zeros((), dtype=torch.float32, device=b.device)
    for _ in range(iters):
        p = halo.dispatch("MVM", a, x, overrides=ov)
        x_new = halo.dispatch(
            "EWMD",
            halo.dispatch("EWADD",
                          halo.dispatch("EWSUB", b, p, overrides=ov),
                          halo.dispatch("EWMM", d, x, overrides=ov),
                          overrides=ov),
            d, overrides=ov)
        e = halo.dispatch("EWSUB", x_new, x, overrides=ov)
        res = halo.dispatch("VDP", e, e, overrides=ov)
        x = x_new
    return x, float(res)


def collective_jacobi(comm, a, b, d, iters: int):
    """Blocking collective verbs: scatter once, then per iteration an
    allgather (iterate exchange), member-pinned sweeps and an allreduce
    residual check."""
    A = comm.scatter(a)
    B = comm.scatter(b)
    D = comm.scatter(d)
    X = comm.scatter(torch.zeros_like(b))
    res = 0.0
    for _ in range(iters):
        xs = comm.allgather(X)
        P = comm.map("MVM", list(zip(A, xs)))
        T = comm.map("EWSUB", list(zip(B, P)))
        U = comm.map("EWMM", list(zip(D, X)))
        V = comm.map("EWADD", list(zip(T, U)))
        Xn = comm.map("EWMD", list(zip(V, D)))
        E = comm.map("EWSUB", list(zip(Xn, X)))
        S = comm.map("VDP", list(zip(E, E)))
        res = float(comm.allreduce(S, op="sum")[0])   # every member agrees
        X = Xn
    return comm.gather(X), res


def collective_jacobi_graph(comm, a, b, d, iters: int):
    """The same iteration loop captured as ONE execution graph: every
    collective records multi-parent nodes, member branches overlap and
    each reduce combine is placed among the members.  Returns the graph,
    the iterate and the last residual."""
    A = comm.scatter(a)
    B = comm.scatter(b)
    D = comm.scatter(d)
    X = comm.scatter(torch.zeros_like(b))
    with halo.graph(session=comm.session) as g:
        R = None
        for _ in range(iters):
            xs = comm.iallgather(X)
            P = comm.imap("MVM", list(zip(A, xs)))
            T = comm.imap("EWSUB", list(zip(B, P)))
            U = comm.imap("EWMM", list(zip(D, X)))
            V = comm.imap("EWADD", list(zip(T, U)))
            Xn = comm.imap("EWMD", list(zip(V, D)))
            E = comm.imap("EWSUB", list(zip(Xn, X)))
            S = comm.imap("VDP", list(zip(E, E)))
            R = comm.iallreduce(S, op="sum")
            X = Xn
        out = comm.igather(X)
    return g, halo.wait(out), float(halo.wait(R[0]))


def solve_error(a, b, x) -> float:
    """‖A·x − b‖ / ‖b‖ in float64."""
    a64, b64 = a.double(), b.double()
    return float(torch.linalg.vector_norm(a64 @ x.double() - b64)
                 / torch.linalg.vector_norm(b64))


def _time(fn, sync, repeats: int = 3) -> float:
    fn()                                              # warm-up / build
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> None:
    """Command-line entry: serial, eager and graph runs, their agreement,
    and the T3/Φ scorecard against serial on the first member's substrate."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; needs an H100) or cpu")
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--group", default="hopper,hopper,hopper,hopper",
                   help="member substrates in rank order")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    session = halo.initialize(device=args.device)
    a, b, d = problem(args.n, session.device, args.seed)
    comm = halo.comm_split(args.group.split(","))
    base = comm.platforms[0]
    print(f"device group: {comm} ({comm.size} member ranks) on {session.device}")

    def sync():
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)

    x_serial, res_serial = serial_jacobi(a, b, d, args.iters, base)
    x_eager, res_eager = collective_jacobi(comm, a, b, d, args.iters)
    g, x_graph, res_graph = collective_jacobi_graph(comm, a, b, d, args.iters)
    one_substrate = len(comm.members) == 1
    same_eager = torch.equal(x_eager, x_serial)
    same_graph = torch.equal(x_graph, x_eager) and res_graph == res_eager
    print(f"collective x == serial {base} x bit for bit: {same_eager}; graph == "
          f"eager bit for bit: {same_graph}; residual {res_eager:.3e} (serial "
          f"{res_serial:.3e}); relative solve error "
          f"{solve_error(a, b, x_eager):.2e}")
    plats = sorted(set(filter(None, g.placements().values())))
    print(f"graph: {len(g.nodes)} nodes over substrates {plats}")

    t_base = _time(lambda: serial_jacobi(a, b, d, args.iters, base), sync)
    rows = [(f"serial-{base}(baseline)", t_base)]
    for other in dict.fromkeys(comm.platforms[1:]):
        if other != base:
            rows.append((f"serial-{other}", _time(
                lambda: serial_jacobi(a, b, d, args.iters, other), sync)))
    rows.append(("collective-eager",
                 _time(lambda: collective_jacobi(comm, a, b, d, args.iters), sync)))
    rows.append(("collective-graph", _time(
        lambda: collective_jacobi_graph(comm, a, b, d, args.iters), sync)))
    print("policy,T3_ms,phi_vs_serial")
    for name, t in rows:
        print(f"{name},{t * 1e3:.3f},{portability_score(t_base, t):.3f}")
    halo.finalize()
    if not same_graph or (one_substrate and not same_eager):
        raise SystemExit("the collective runs disagree bit for bit")


if __name__ == "__main__":
    main()
