"""Mixture-of-experts FFN (GShard/DeepSeek style), the one-device path —
port of ``repro.models.moe``.

Each token's router picks its top-k experts; tokens are scattered into
per-expert capacity slots by index (an argsort-free scatter of at most
T·k rows; the (T,E,C) one-hot dispatch tensor is never built), the
grouped expert FFN runs through the MOE_FFN alias over all experts at once,
and a gather-combine applies the router gates.  Rows past an expert's
capacity are dropped, in the reference's order: slots are claimed in
flattened (token, k) order.  No step reads a count back to the host: the
capacity C is computed from the token count alone.

Shared (always-on) experts run beside the routed ones as a plain dense
FFN through MMM.  The router aux loss is Switch-style load balancing.

:func:`moe_expert_parallel` runs the routed experts over a C²MPI device
group instead: the session routes and dispatches, the expert blocks and
weight stacks scatter over the members, each member runs MOE_FFN on its
experts, and the outputs gather for the combine.

Under a mesh (``distributed.sharding.mesh_context``) :func:`moe_layer`
runs the routed experts in a ``shard_map`` region (``distributed.mesh_ops``)
in one of the reference's two modes, chosen by token count:

* **a2a** (prefill): tokens split over the (fsdp × expert) ranks; each
  rank routes its tokens into capacity slots, a tiled all_to_all over the
  expert axis sends each expert's rows to the rank that owns it (in
  bfloat16, or int8 with per-row scales: :func:`_a2a_int8`), the rank runs
  MOE_FFN on its experts, and the inverse exchange brings the outputs back
  for the combine.
* **replicated** (decode): too few tokens to split over the expert axis;
  every expert-axis rank routes the same tokens, serves only its own
  experts, and a psum over the expert axis adds the partial outputs.

Expert weights enter the region split E over "expert" only.  The
reference also splits their D over "fsdp" and all-gathers it in the body;
here parameter storage is whole on every rank (the global view), so that
gather would only send back bytes every rank already holds (placed
storage is ROADMAP A13's, with its only reader).  The shared experts run
outside the region on every rank.

Both bodies differentiate through ``mesh_ops``' verbs, whose backward
rules keep the global view: the gradients under a mesh are the
one-device path's (to rounding), on every rank; the expert weights'
"data" sum comes from their block's backward.  The int8 dispatch is
straight-through.  The bodies count their calls in :data:`BODY_CALLS`,
so a check can see that a mesh call took the mesh path: the context is
thread-local, and a thread started elsewhere takes the one-device path
(``Model.loss_fn``'s recompute re-enters the forward's context).
"""
from __future__ import annotations

import collections
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..core.c2mpi import halo_dispatch
from ..distributed import mesh_ops
from ..distributed.sharding import P, ParamSpec, current_context
from .layers import act_fn, dense

Params = Dict[str, torch.Tensor]

#: calls of each shard_map body in this process ("a2a", "replicated")
BODY_CALLS: collections.Counter = collections.Counter()


def moe_param_specs(d_model: int, m: MoEConfig, dtype) -> Dict[str, ParamSpec]:
    """The router in float32, the stacked expert weights and the shared
    experts' (``n_shared`` experts side by side) in ``dtype``."""
    e, f = m.n_experts, m.d_ff_expert
    specs = {
        "router": ParamSpec((d_model, e), torch.float32, ("fsdp", None)),
        "we_g": ParamSpec((e, d_model, f), dtype, ("expert", "fsdp", None)),
        "we_u": ParamSpec((e, d_model, f), dtype, ("expert", "fsdp", None)),
        "we_d": ParamSpec((e, f, d_model), dtype, ("expert", None, "fsdp")),
    }
    if m.n_shared:
        fs = m.n_shared * f
        specs.update({
            "ws_g": ParamSpec((d_model, fs), dtype, ("fsdp", None)),
            "ws_u": ParamSpec((d_model, fs), dtype, ("fsdp", None)),
            "ws_d": ParamSpec((fs, d_model), dtype, (None, "fsdp")),
        })
    return specs


# ---------------------------------------------------------------------------
# Local (single-shard) routing + expert compute
# ---------------------------------------------------------------------------
def _router_probs(x2: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(T,E) float32 softmax of the router logits.  The logits are float32
    products of x2 and the router weights rounded to x2's type, as the
    reference's bfloat16 einsum with float32 accumulation computes them: a
    bfloat16 product would round the logits and flip experts."""
    logits = torch.matmul(x2.float(), router_w.to(x2.dtype).float())
    return torch.softmax(logits, dim=-1)


def _route(x2: torch.Tensor, router_w: torch.Tensor, m: MoEConfig):
    """(gates (T,k) float32 renormalised over the top k, expert indices
    (T,k) in descending probability, the Switch aux loss)."""
    probs = _router_probs(x2, router_w)
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load-balance aux: E * sum_e (frac_tokens_e * frac_prob_e)
    e = m.n_experts
    frac_tok = F.one_hot(eidx[:, 0], e).float().mean(dim=0)
    frac_prob = probs.mean(dim=0)
    aux = e * torch.sum(frac_tok * frac_prob)
    return gates, eidx, aux


def _capacity(t: int, m: MoEConfig, world: int = 1) -> int:
    c = int(t * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _dispatch_indices(eidx: torch.Tensor, t: int, c: int, e: int):
    """Capacity-slot assignment: each (token, k) row, in flattened order,
    takes the next slot of its expert.  Returns (slot (T,k), keep (T,k));
    a row past its expert's ``c`` slots is not kept."""
    fe = eidx.reshape(-1)                               # (T*k,)
    pos = torch.cumsum(F.one_hot(fe, e), dim=0) - 1     # position per expert
    pos_in_e = pos.gather(1, fe[:, None])[:, 0]
    keep = pos_in_e < c
    slot = fe * c + pos_in_e
    return slot.reshape(t, -1), keep.reshape(t, -1)


def _gather_dispatch(x2, slot, keep, e: int, c: int, k: int):
    """Scatter kept (token, k) rows into (E*C, D) capacity slots; dropped
    rows land in a sink row ``e·c`` that is cut off."""
    t, d = x2.shape
    token_idx = torch.arange(t, device=x2.device).repeat_interleave(k)
    slot_safe = torch.where(keep.reshape(-1), slot.reshape(-1), e * c)
    buf = x2.new_zeros((e * c + 1, d))
    buf[slot_safe] = x2[token_idx]
    return buf[:-1].reshape(e, c, d)


def _combine(ye, slot, keep, gates, t: int, k: int):
    """Σ over each token's k slots of gate × expert output, in float32; a
    dropped row weighs 0."""
    d = ye.shape[-1]
    ye_flat = ye.reshape(-1, d)
    vals = ye_flat[slot.reshape(-1).clamp(0, ye_flat.shape[0] - 1)]
    w = (gates.reshape(-1) * keep.reshape(-1)).float()[:, None]
    return (vals.float() * w).reshape(t, k, d).sum(dim=1)


def _expert_ffn(xe, wg, wu, wd, act: str):
    return halo_dispatch("MOE_FFN", xe, wg.to(xe.dtype), wu.to(xe.dtype),
                         wd.to(xe.dtype))


def _moe_local(p: Params, x2: torch.Tensor, m: MoEConfig, act: str,
               expert_ffn=_expert_ffn):
    """The single-shard path: (y (T,D) in x2's type, aux).  ``expert_ffn``
    runs the routed experts on the (E,C,D) blocks."""
    t = x2.shape[0]
    gates, eidx, aux = _route(x2, p["router"], m)
    c = _capacity(t, m)
    slot, keep = _dispatch_indices(eidx, t, c, m.n_experts)
    xe = _gather_dispatch(x2, slot, keep, m.n_experts, c, m.top_k)
    ye = expert_ffn(xe, p["we_g"], p["we_u"], p["we_d"], act)
    y = _combine(ye, slot, keep, gates, t, m.top_k)
    return y.to(x2.dtype), aux


def _moe(p: Params, x: torch.Tensor, m: MoEConfig, routed
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) → (y (B,S,D), aux loss × ``router_aux_weight``): shared
    experts through MMM, then ``routed(x2)`` → (y (T,D), aux)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    y_sh = None
    if p.get("ws_g") is not None:
        g = dense(x2, p["ws_g"])
        u = dense(x2, p["ws_u"])
        y_sh = dense(act_fn("swiglu", g, u), p["ws_d"])
    y, aux = routed(x2)
    if y_sh is not None:
        y = y + y_sh.to(y.dtype)
    return y.reshape(b, s, d).to(x.dtype), aux * m.router_aux_weight


def moe_layer(p: Params, x: torch.Tensor, m: MoEConfig, act: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) → (y (B,S,D), aux loss × ``router_aux_weight``): shared
    experts through MMM, then the routed ones — in one process, or under
    the thread's mesh in the a2a or the replicated body."""
    ctx = current_context()
    ep_axes = ctx.rules.expert
    if ctx.mesh is None or not ep_axes:
        return _moe(p, x, m, lambda x2: _moe_local(p, x2, m, act, _expert_ffn))
    assert len(ep_axes) == 1, "single expert axis supported"
    ep_axis = ep_axes[0]
    dp_axes = tuple(a for a in ctx.rules.fsdp if a != ep_axis)
    t = x.shape[0] * x.shape[1]
    n_dp, n_ep = ctx.axis_size(dp_axes), ctx.axis_size(ep_axes)
    a2a_ok = (m.n_experts % n_ep == 0 and t % (n_dp * n_ep) == 0
              and t // (n_dp * n_ep) >= m.top_k)
    body = _moe_a2a_body if a2a_ok else _moe_replicated_body
    tok_spec = P((*dp_axes, ep_axis), None) if a2a_ok else P(dp_axes or None, None)
    fn = mesh_ops.shard_map(
        functools.partial(body, m=m, act=act, mesh=ctx.mesh, ep_axis=ep_axis,
                          n_ep=n_ep, dp_axes=dp_axes),
        ctx.mesh,
        in_specs=(tok_spec, P(None, None), P(ep_axis, None, None),
                  P(ep_axis, None, None), P(ep_axis, None, None)),
        out_specs=(tok_spec, P()))
    return _moe(p, x, m, lambda x2: fn(x2, p["router"], p["we_g"], p["we_u"],
                                       p["we_d"]))


def moe_expert_parallel(p: Params, x: torch.Tensor, m: MoEConfig, act: str,
                        comm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over a C²MPI device group (DESIGN.md §15).

    Host-side eager twin of :func:`moe_layer`'s local path: the shared
    experts, routing and the capacity dispatch run on the session, then the
    (E,C,D) expert blocks and the expert weight stacks scatter over the
    group's member ranks (E split on axis 0, ``E % comm.size == 0``), every
    member runs ``MOE_FFN`` on its expert slice, and a gather reassembles
    the outputs for the gate-combine.  Per-expert FFNs are independent, so
    the result is bit-identical to the single-shard path wherever each
    member runs the record that path runs.  A member whose substrate has
    no MOE_FFN row (``hopper``) runs the registry's fail-safe, the
    ``torch`` row, in the host process."""
    e, n = m.n_experts, comm.size
    if e % n:
        raise ValueError(f"n_experts ({e}) must divide over the {n}-member "
                         f"device group")

    def group_ffn(xe, wg, wu, wd, act):
        parts = [comm.scatter(w.to(xe.dtype), axis=0) for w in (xe, wg, wu, wd)]
        return comm.gather(comm.map("MOE_FFN", list(zip(*parts))))
    return _moe(p, x, m, lambda x2: _moe_local(p, x2, m, act, group_ffn))


# ---------------------------------------------------------------------------
# Mesh paths: the shard_map bodies
# ---------------------------------------------------------------------------
class _Int8Exchange(torch.autograd.Function):
    """all_to_all in an int8 wire format: per-row absmax scales (float32,
    floored at 1e-12, over 127) ride along; rounding half to even, clipped
    to ±127, dequantized to xe's type (the reference's bits).  Halves the
    dispatch bytes of bfloat16.  The backward is straight-through on the
    rounding, as the reference documents (its int8 cast cuts the gradient
    but the scales' path: ROADMAP C): the cotangent goes back by the
    inverse exchange in xe's type."""

    @staticmethod
    def forward(ctx, xe, mesh, ep_axis: str, split_axis: int, concat_axis: int):
        ctx.args = (mesh, ep_axis, split_axis, concat_axis)
        xf = xe.float()
        scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
        q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        q = mesh_ops.all_to_all(q, mesh, ep_axis, split_axis, concat_axis)
        scale = mesh_ops.all_to_all(scale, mesh, ep_axis, split_axis, concat_axis)
        return (q.float() * scale).to(xe.dtype)

    @staticmethod
    def backward(ctx, g):
        mesh, ep_axis, split_axis, concat_axis = ctx.args
        return (mesh_ops.all_to_all(g, mesh, ep_axis, concat_axis, split_axis),
                None, None, None, None)


def _a2a_int8(xe, mesh, ep_axis: str, split_axis: int, concat_axis: int):
    """:class:`_Int8Exchange`: the int8 dispatch, straight-through."""
    return _Int8Exchange.apply(xe, mesh, ep_axis, split_axis, concat_axis)


def _moe_a2a_body(x2, router_w, wg, wu, wd, *, m: MoEConfig, act: str, mesh,
                  ep_axis: str, n_ep: int, dp_axes: Tuple[str, ...]):
    """a2a mode.  x2 (T_loc, D); wg/wu (E_loc, D, F); wd (E_loc, F, D)."""
    BODY_CALLS["a2a"] += 1
    t = x2.shape[0]
    gates, eidx, aux = _route(x2, router_w, m)
    c = _capacity(t, m)
    slot, keep = _dispatch_indices(eidx, t, c, m.n_experts)
    xe = _gather_dispatch(x2, slot, keep, m.n_experts, c, m.top_k)
    # (E, C, D) → (E/n_ep, C·n_ep, D): tokens to their experts' owners
    if m.a2a_precision == "int8":
        xe = _a2a_int8(xe, mesh, ep_axis, 0, 1)
    else:
        xe = mesh_ops.all_to_all(xe, mesh, ep_axis, 0, 1)
    ye = _expert_ffn(xe, wg, wu, wd, act)
    # the inverse exchange: expert outputs back to their tokens' owners
    ye = mesh_ops.all_to_all(ye, mesh, ep_axis, 1, 0)
    y = _combine(ye, slot, keep, gates, t, m.top_k)
    aux = mesh_ops.pmean(aux, mesh, (*dp_axes, ep_axis))
    return y.to(x2.dtype), aux


def _moe_replicated_body(x2, router_w, wg, wu, wd, *, m: MoEConfig, act: str,
                         mesh, ep_axis: str, n_ep: int,
                         dp_axes: Tuple[str, ...]):
    """Replicated mode (decode).  x2 (T_loc, D) is the same on every rank
    of the expert axis; each rank serves only its experts and the partial
    outputs psum over the expert axis."""
    BODY_CALLS["replicated"] += 1
    t = x2.shape[0]
    e_loc = m.n_experts // n_ep
    first = mesh_ops.axis_index(mesh, ep_axis) * e_loc
    gates, eidx, aux = _route(x2, router_w, m)
    # keep only the assignments to this rank's experts
    local = (eidx >= first) & (eidx < first + e_loc)
    gates_loc = torch.where(local, gates, 0.0)
    c = _capacity(t, m, n_ep)
    slot, keep = _dispatch_indices(torch.where(local, eidx - first, e_loc), t,
                                   c, e_loc + 1)
    keep = keep & local
    xe = _gather_dispatch(x2, slot, keep, e_loc + 1, c, m.top_k)[:e_loc]
    ye = _expert_ffn(xe, wg, wu, wd, act)
    ye = torch.cat([ye, torch.zeros_like(ye[:1])], dim=0)
    y = _combine(ye, slot, keep, gates_loc, t, m.top_k)
    y = mesh_ops.psum(y, mesh, (ep_axis,))
    aux = mesh_ops.pmean(aux, mesh, (*dp_axes, ep_axis))
    return y.to(x2.dtype), aux
