"""Execution-graph pipeline: unified control flow over a DAG (DESIGN.md §8,
§12) — port of ``examples/graph_pipeline.py``.

The host program is the paper's hardware-agnostic template, unchanged but
for the ``halo.graph()`` region: inside it, ``isend`` records DAG nodes
instead of executing, with dependencies inferred from which node handles
appear in later payloads.  The dependent chain EWMM → MMM → RMSNORM and an
independent branch of Jacobi sweeps are placed per node and run on the
agents' workers.  Then the same capture is compiled once — the fusion pass
collapses each chain into one fused node — and replayed, as a steady-state
loop would.  Every claim is pinned to the hopper records (the kernels on
the card, their plain versions on the CPU), so every result must equal
serial one-kernel-at-a-time dispatch bit for bit: the graph runs the same
records, and fusion keeps each member's launches.

Run:  PYTHONPATH=src python -m repro_torch.graph_pipeline [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from . import halo

ALIASES = ("EWMM", "MMM", "RMSNORM", "JS")
PIN = {"allowed_platforms": ["hopper"]}


def make_inputs(n: int, device, seed: int = 0):
    """float32 operands on ``device`` from ``seed``: a, b (b shifted away
    from 0), gamma, a diagonally dominant system A + n·I with b, and x0."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    a, b = normal(n, n), normal(n, n) + 3.0
    a_dd = normal(n, n)
    a_dd.diagonal().add_(float(n))
    return {"a": a, "b": b, "gamma": torch.ones(n, device=device),
            "A": a_dd, "bvec": normal(n), "x0": torch.zeros(n, device=device)}


def workload(w, send, sweeps: int):
    """The host program's requests through ``send(alias, payload)``:
    the chain and the Jacobi branch; returns both results."""
    t = send("EWMM", (w["a"], w["b"]))          # chain: ewise ...
    m = send("MMM", (t, w["b"]))                # ... matmul ...
    r = send("RMSNORM", (m, w["gamma"]))        # ... rmsnorm
    x = w["x0"]
    for _ in range(sweeps):                     # independent branch
        x = send("JS", (w["A"], x, w["bvec"]))
    return r, x


def run(w, sweeps: int = 4, replays: int = 3):
    """Serial dispatch, one launched graph and a compiled graph replayed
    ``replays`` times, on the live session; returns the results and
    timings of each, device-ready."""
    session = halo.session()
    cr = {alias: halo.claim(alias, overrides=PIN) for alias in ALIASES}

    def sync():
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)

    t0 = time.perf_counter()
    serial = workload(w, lambda al, p: halo.wait(
        halo.isend(p, cr[al], mailbox=False)), sweeps)
    sync()
    serial_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with halo.graph() as g:
        workload(w, lambda al, p: halo.isend(p, cr[al]), sweeps)
    launched = g.wait(timeout=300)
    sync()
    graph_s = time.perf_counter() - t0

    with halo.graph(launch=False) as g2:
        workload(w, lambda al, p: halo.isend(p, cr[al]), sweeps)
    t0 = time.perf_counter()
    cg = g2.compile()
    compile_s = time.perf_counter() - t0
    replay_s = []
    for _ in range(replays):
        t0 = time.perf_counter()
        replayed = cg.replay(timeout=300)
        sync()
        replay_s.append(time.perf_counter() - t0)
    for c in cr.values():
        halo.free(c)
    return {"serial": serial, "graph": tuple(launched),
            "replay": tuple(replayed), "graph_nodes": g.nodes,
            "stats": cg.stats, "serial_s": serial_s, "graph_s": graph_s,
            "compile_s": compile_s, "replay_s": replay_s}


def main(argv=None) -> None:
    """Command-line entry: run the pipeline once and print what came out."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; needs an H100) or cpu")
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--sweeps", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    session = halo.initialize(device=args.device)
    res = run(make_inputs(args.n, session.device, args.seed), args.sweeps)
    g = res["graph_nodes"]
    print(f"graph: {len(g)} nodes, {sum(1 for n in g if not n.parents)} roots")
    for node in g:
        deps = ",".join(str(p.uid) for p in node.parents) or "-"
        print(f"  node {node.uid:2d} {node.alias:8s} deps=[{deps:7s}] "
              f"ran on {node.platform}")
    st = res["stats"]
    print(f"compiled: {st['captured_nodes']} captured -> {st['nodes']} nodes, "
          f"{st['fused_nodes']} fused, {st['intermediates_eliminated']} "
          f"intermediates eliminated; {st['fused_aliases']}")
    same = all(torch.equal(s, o) for mode in ("graph", "replay")
               for s, o in zip(res["serial"], res[mode]))
    print(f"serial {res['serial_s'] * 1e3:.1f} ms, graph "
          f"{res['graph_s'] * 1e3:.1f} ms, compile {res['compile_s'] * 1e3:.1f}"
          f" ms, replay {min(res['replay_s']) * 1e3:.1f} ms on {session.device}")
    print(f"graph and replay equal serial dispatch bit for bit: {same}")
    halo.finalize()
    if not same:
        raise SystemExit("graph results differ from serial dispatch")


if __name__ == "__main__":
    main()
