"""Performance portability demo: one host program, many substrates — port
of ``examples/portability_demo.py``.

Demonstrates the three HALO properties the paper claims:
  1. *unified control flow* — the host line ``agent.invoke(cr, a, b)`` never
     changes while the execution substrate does (torch fail-safe → aten →
     hopper);
  2. *plug-and-play extensibility* — a new virtualization agent and its
     kernel record, registered with ``@registry.register_fn``, are attached
     at run time and win selection at once;
  3. *fail-safe mode* — a claim of an alias no record implements runs the
     user-supplied fail-safe callback (§IV-C).

The demo's runtime agent selects statically (no cost-model scheduler): the
substrate policy alone decides which record serves, so each policy picks
the most preferred substrate it allows.  On a card session every call runs
on the card; the hopper policy's MMM is the 3×TF32 route at 512×512
float32.

Run:  PYTHONPATH=src python -m repro_torch.portability_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List

import torch

from .core import (KernelAttributes, KernelRegistry, RuntimeAgent,
                   VirtualizationAgent, default_manifest, performance_penalty,
                   portability_score)
from .kernels import register_all

#: the substrate policies of part 1, in the reference's order
POLICIES = (["torch"], ["torch", "aten"], ["torch", "aten", "hopper"])
#: the policy whose T3 is the baseline of Φ and the penalty (the library's)
BASELINE = "aten"
#: the operands' generator seed
SEED = 0


class FancyAgent(VirtualizationAgent):
    """A substrate attached at run time (part 2)."""
    platform = "fancy"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn, device: torch.device, iters: int = 5) -> float:
    """Seconds per call of ``fn`` by the host clock, after one warm call,
    each call's device work finished before the clock stops."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _served(agent: RuntimeAgent) -> Dict[str, int]:
    return {p: a.metrics["requests"] for p, a in agent.agents.items()}


def run(device, n: int = 512, iters: int = 5) -> Dict[str, Any]:
    """The three parts on ``device`` with n×n float32 operands from
    :data:`SEED`.  Returns, per policy, the platforms whose agents served
    its invokes (``served``: platform → requests; ``picked``: those
    platforms joined by ``+``), its result, its invokes (``calls``) and its
    T3 (seconds per call), Φ and penalty against :data:`BASELINE`; the
    fancy agent's result and requests served; the fail-safe's result and
    whether its callback ran."""
    device = torch.device(device)
    registry = KernelRegistry()
    register_all(registry)
    agent = RuntimeAgent(registry=registry, manifest=default_manifest(),
                         scheduler=False, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    a = torch.randn((n, n), generator=gen, device=device)
    b = torch.randn((n, n), generator=gen, device=device)
    try:
        # -- 1. the SAME host line under three substrate policies -----------
        policies: List[Dict[str, Any]] = []
        for allowed in POLICIES:
            cr = agent.claim("MMM", overrides={"allowed_platforms": allowed})
            before = _served(agent)
            out = agent.invoke(cr, a, b)
            t3 = time_call(lambda: agent.invoke(cr, a, b), device, iters)
            served = {p: k - before[p] for p, k in _served(agent).items()
                      if k > before[p]}
            policies.append({"allowed": list(allowed), "picked": "+".join(sorted(served)),
                             "served": served, "t3_s": t3, "out": out,
                             "calls": 2 + iters})
        base = next(p["t3_s"] for p in policies if p["picked"] == BASELINE)
        for p in policies:
            p["phi"] = portability_score(base, p["t3_s"])
            p["penalty_pct"] = performance_penalty(p["t3_s"], base)

        # -- 2. plug-and-play: attach a new agent + kernel at run time ------
        fancy = FancyAgent()
        agent.attach_agent(fancy)

        @registry.register_fn("MMM", "fancy", priority=99,
                              attrs=KernelAttributes(vid="acme", pid="accel-x",
                                                     sw_fid="fid:mmm"))
        def mmm_fancy(x, y):
            """The attached substrate's MMM: a float32 product."""
            return torch.matmul(x.float(), y.float()).to(x.dtype)

        cr = agent.claim("MMM", overrides={
            "allowed_platforms": ["torch", "aten", "hopper", "fancy"],
            "platform_preference": ["fancy", "hopper", "aten", "torch"]})
        fancy_out = agent.invoke(cr, a, b)

        # -- 3. fail-safe mode ----------------------------------------------
        engaged: List[bool] = []

        def failsafe(x, y):
            engaged.append(True)
            return torch.zeros((x.shape[0], y.shape[1]), dtype=x.dtype,
                               device=x.device)

        cr = agent.claim("NOT_A_KERNEL", failsafe=failsafe)
        agent.send((a, b), cr)
        fs_out = agent.recv(cr)
        return {"a": a, "b": b, "policies": policies,
                "fancy": {"out": fancy_out, "served": fancy.metrics["requests"]},
                "failsafe": {"out": fs_out, "engaged": bool(engaged)}}
    finally:
        agent.finalize()


def main(argv=None) -> None:
    """Command-line entry: run the three parts and print what came out."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs an H100) or cpu")
    args = p.parse_args(argv)
    res = run(args.device)
    for pol in res["policies"]:
        print(f"substrates={pol['allowed']!s:28s} -> {pol['picked']:6s} "
              f"{pol['t3_s'] * 1e3:8.3f} ms/call  Φ={pol['phi']:.3f} "
              f"penalty={pol['penalty_pct']:+.1f}% vs {BASELINE}")
    print(f"plug-and-play agent served MMM: {tuple(res['fancy']['out'].shape)} "
          f"(platform=fancy, prio=99, requests={res['fancy']['served']})")
    print(f"fail-safe callback engaged={res['failsafe']['engaged']}: "
          f"{tuple(res['failsafe']['out'].shape)}")


if __name__ == "__main__":
    main()
