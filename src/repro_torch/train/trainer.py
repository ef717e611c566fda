"""Training loop: grad accumulation, per-layer recompute, optional int8
gradient compression, checkpoint/restart, heartbeat — port of
``repro.train.trainer``.

A train step is loss (each stage repeat recomputed in the backward,
``Model.loss_fn``) → grads (``torch.autograd`` through the MMM, RMSNORM
and FLASH_ATTN rows' ``autograd.Function``s and the embedding's, whose
backward is EMBED_GRAD) → optional quantize and dequantize with error
feedback → AdamW with the warmup-cosine schedule.  It runs eagerly on the
session's device.

**Data-parallel comm mode** (DESIGN.md §15): ``comm=`` (a
:class:`~repro_torch.core.collective.HaloComm` device group) and ``arch=``
switch :meth:`Trainer.run` to the C²MPI path: per member and microbatch an
``LM_GRAD`` dispatch pinned to the member's agent, a balanced ``EWADD``
tree over each member's microbatches, an ``iallreduce`` across members,
and one ``ADAMW_STEP`` node on rank 0's member, captured once into a
``halo_graph`` and replayed each step through the §12 compiled-graph
cache.  Member *r* owns a contiguous block of microbatches, so the local
trees and the allreduce's tree compose into one balanced tree whatever
the member count, and the members only ever add float32 vectors: the loss
history, parameters and moments are bit-identical for 1, 2 and 4 members
at equal global batch, the card included, since every kernel of
``LM_GRAD`` repeats bit for bit there (EMBED_GRAD sums in a fixed order).
A member's death moves ``comm.epoch`` (the comm re-binds its ranks) and
the loop recaptures on the re-bound group (§11).

**Under a mesh** (``distributed.sharding.mesh_context``, one process a
rank: ``launch/train.py --mesh``) the step is the same code, as the
reference's ``jax.jit`` step is under its mesh: every rank takes the whole
batch and holds the whole state (the global view), the MoE layers run
their ``shard_map`` bodies, and the backward through the bodies'
collectives hands every rank the whole gradient, so every rank makes the
same update.  Only rank 0 logs and beats the heartbeat; the checkpoint
manager lets rank 0 alone write.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..distributed.sharding import current_context
from ..models.transformer import Model
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..optim.compression import compress_gradients, decompress_gradients
from ..optim.schedule import linear_warmup_cosine
from .checkpoint import CheckpointManager
from .fault_tolerance import HeartbeatJournal, StragglerPolicy

log = logging.getLogger("repro_torch.train")
PyTree = Any

@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt: AdamWState
    err_fb: Optional[PyTree] = None      # gradient-compression error feedback


# flattened as the reference's registered dataclass: params, opt, err_fb
pytree.register_pytree_node(
    TrainState, lambda s: ([s.params, s.opt, s.err_fb], None),
    lambda children, _: TrainState(*children))


@dataclasses.dataclass
class TrainHyper:
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1
    compress_grads: bool = False


def loss_and_grads(model: Model, params: PyTree, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``: the
    reference's ``jax.value_and_grad(..., has_aux=True)``.  Each gradient
    is in its parameter's dtype; a parameter the loss does not reach gets
    zeros."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(tree_unflatten(spec, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(spec, grads))


def _lead() -> bool:
    """False on a rank other than 0 under a mesh, which logs nothing and
    beats no heartbeat."""
    return current_context().mesh is None or dist.get_rank() == 0


def _donate(old: PyTree, new: PyTree) -> None:
    """Free ``old``'s tensors once ``new`` exists: the reference's step
    donates its input state (``donate_argnums``), so a full-depth run holds
    two states at a time, not three (the caller's first state stays alive
    otherwise).  A tensor whose storage ``new`` still uses is kept, and so
    is one on memory torch does not own (a numpy array's).  Freeing goes by
    storage, so a reference kept elsewhere (a compiled graph's capture-time
    inputs) holds no memory either."""
    live = {t.untyped_storage().data_ptr() for t in tree_leaves(new)}
    for t in tree_leaves(old):
        storage = t.untyped_storage()
        if storage.data_ptr() not in live and storage.resizable():
            storage.resize_(0)


def make_train_step(model: Model, hp: TrainHyper) -> Callable:
    """Returns train_step(state, batch) → (state, metrics)."""

    def accumulate(params, batch):
        m = hp.microbatches
        if m <= 1:
            return loss_and_grads(model, params, batch)
        # split the global batch into m microbatches and accumulate in float32
        loss_a = grads_a = metrics = None
        for i in range(m):
            mb = {k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, metrics, grads = loss_and_grads(model, params, mb)
            if grads_a is None:
                loss_a = torch.zeros((), dtype=torch.float32, device=loss.device)
                grads_a = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                         device=p.device), params)
            loss_a = loss_a + loss
            grads_a = tree_map(torch.add, grads_a, grads)
        return loss_a / m, metrics, tree_map(lambda g: g / m, grads_a)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = accumulate(state.params, batch)
        err_fb = state.err_fb
        if hp.compress_grads:
            q, scales, err_fb = compress_gradients(grads, err_fb)
            grads = decompress_gradients(q, scales, grads)
        lr = linear_warmup_cosine(state.opt.step, base_lr=hp.base_lr,
                                  warmup_steps=hp.warmup_steps,
                                  total_steps=hp.total_steps)
        params, opt, om = adamw_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=hp.weight_decay, clip_norm=hp.clip_norm)
        new_state = TrainState(params=params, opt=opt, err_fb=err_fb)
        return new_state, {"loss": loss, "lr": lr, **metrics, **om}

    return train_step


@dataclasses.dataclass
class Trainer:
    """Host-side loop: data, the step, checkpoints, heartbeat, resume.

    ``straggler`` (when set) observes every step's wall time in both modes;
    straggler events are logged with the policy's recommendation.  ``comm``
    + ``arch`` select the data-parallel C²MPI mode (module docstring);
    ``arch`` must resolve through :func:`repro_torch.train.step_kernels.
    resolve_arch` to the same architecture as ``model``."""
    model: Model
    hp: TrainHyper
    ckpt: Optional[CheckpointManager] = None
    heartbeat: Optional[HeartbeatJournal] = None
    straggler: Optional[StragglerPolicy] = None
    comm: Optional[Any] = None           # HaloComm device group (§15)
    arch: Optional[str] = None           # config id for LM_GRAD/ADAMW_STEP
    arch_reduced: bool = False
    log_every: int = 10
    ckpt_every: int = 50

    def init_state(self, generator: torch.Generator) -> TrainState:
        params = self.model.init(generator)
        state = TrainState(params=params, opt=adamw_init(params))
        if self.hp.compress_grads:
            state.err_fb = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                params)
        return state

    def restore_or_init(self, generator: torch.Generator) -> Tuple[TrainState, int]:
        state = self.init_state(generator)
        if self.ckpt is not None:
            restored, step = self.ckpt.restore_latest(like=state)
            if restored is not None:
                log.info("resumed from checkpoint at step %d", step)
                return restored, step
        return state, 0

    def _observe_straggler(self, step: int, dt: float, lead: bool = True) -> None:
        if self.straggler is not None and self.straggler.observe(dt) and lead:
            log.warning("step %d straggler: %.2fs vs median %.2fs (%s)",
                        step, dt, self.straggler.median(),
                        self.straggler.recommendation())

    def run(self, state: TrainState, data_fn: Callable[[int], Any],
            steps: int, start_step: int = 0):
        """``steps`` steps from ``start_step``; returns (state, [(step,
        loss)]) with a loss every ``log_every`` steps and at the last.  The
        state passed in is donated, as in the reference: its tensors are
        freed after the first step (in comm mode once flattened)."""
        if self.comm is not None:
            return self._run_comm(state, data_fn, steps, start_step)
        step_fn = make_train_step(self.model, self.hp)
        lead = _lead()
        history = []
        t_last = time.perf_counter()
        for step in range(start_step, start_step + steps):
            t0 = time.perf_counter()
            batch = data_fn(step)
            new_state, metrics = step_fn(state, batch)
            _donate(state, new_state)
            state = new_state
            if self.straggler is not None:
                float(metrics["loss"])          # the step's work, done
            self._observe_straggler(step, time.perf_counter() - t0, lead)
            if self.heartbeat is not None and lead:
                self.heartbeat.beat(step)
            if step % self.log_every == 0 or step == start_step + steps - 1:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                history.append((step, float(metrics["loss"])))
                if lead:
                    log.info("step %5d loss %.4f lr %.2e gnorm %.3f (%.2fs)",
                             step, float(metrics["loss"]), float(metrics["lr"]),
                             float(metrics["grad_norm"]), dt)
            if self.ckpt is not None and step and step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        if self.ckpt is not None:
            self.ckpt.save(start_step + steps - 1, state, wait=True)
        return state, history

    # -- data-parallel comm mode (DESIGN.md §15) ----------------------------
    def _microbatches(self, batch) -> List[List[Any]]:
        """Split a global batch into per-rank microbatch columns:
        ``out[r][j]`` = (tokens, labels, mask) of global microbatch
        ``r * m_local + j``; member *r* owns a contiguous block, so the
        local trees compose into the same balanced tree for every member
        count."""
        n = self.comm.size
        m = self.hp.microbatches
        if m % n:
            raise ValueError(
                f"microbatches ({m}) must divide evenly over the "
                f"{n}-member device group")
        m_local = m // n
        toks, labs, mask = batch["tokens"], batch["labels"], batch["mask"]
        b = toks.shape[0]
        if b % m:
            raise ValueError(f"global batch {b} not divisible into {m} "
                             f"microbatches")
        mb = b // m
        out = []
        for r in range(n):
            cols = []
            for j in range(m_local):
                i = (r * m_local + j) * mb
                cols.append((toks[i:i + mb], labs[i:i + mb], mask[i:i + mb]))
            out.append(cols)
        return out

    def _step_kwargs(self) -> Dict[str, Any]:
        hp = self.hp
        return dict(arch=self.arch, reduced=self.arch_reduced,
                    n_micro=hp.microbatches, base_lr=hp.base_lr,
                    warmup_steps=hp.warmup_steps,
                    total_steps=hp.total_steps,
                    weight_decay=hp.weight_decay, clip_norm=hp.clip_norm)

    def _capture_comm_step(self, vecs, parts):
        """Capture one data-parallel step into a compiled graph.

        ``vecs`` = (pvec, mu, nu, step) tensors, ``parts`` the per-rank
        microbatch columns.  Per column an ``LM_GRAD`` runs pinned on each
        member; each member's results fold through a balanced local
        ``EWADD`` tree; the member partials ``iallreduce``; rank 0's copy
        feeds the single ``ADAMW_STEP`` node (recorded last, so it is the
        final replay output).  Returns (CompiledGraph, updates-slot map)."""
        from ..core.graph import halo_graph
        comm = self.comm
        session = comm.session
        pvec, mu, nu, step_arr = vecs
        n = comm.size
        gkw = {"arch": self.arch, "reduced": self.arch_reduced}
        with halo_graph(session, launch=False) as g:
            cols = [list() for _ in range(n)]
            for j in range(len(parts[0])):
                nodes = comm.imap(
                    "LM_GRAD",
                    [(pvec,) + parts[r][j] for r in range(n)], kwargs=gkw)
                for r in range(n):
                    cols[r].append(nodes[r])
            while len(cols[0]) > 1:
                nxt = [list() for _ in range(n)]
                for i in range(0, len(cols[0]) - 1, 2):
                    nodes = comm.imap(
                        "EWADD",
                        [(cols[r][i], cols[r][i + 1]) for r in range(n)])
                    for r in range(n):
                        nxt[r].append(nodes[r])
                if len(cols[0]) % 2:
                    for r in range(n):
                        nxt[r].append(cols[r][-1])
                cols = nxt
            reduced = comm.iallreduce([cols[r][0] for r in range(n)])
            p0 = comm.platforms[0]
            session.dispatch(
                "ADAMW_STEP", reduced[0], pvec, mu, nu, step_arr,
                overrides={"allowed_platforms": [p0],
                           "platform_preference": [p0]},
                **self._step_kwargs())
        cg = g.compile()
        slots = {
            "pvec": cg.slot_of(pvec), "mu": cg.slot_of(mu),
            "nu": cg.slot_of(nu), "step": cg.slot_of(step_arr),
            "parts": [[tuple(cg.slot_of(a) for a in col) for col in row]
                      for row in parts],
        }
        return cg, slots

    def _run_comm(self, state: TrainState, data_fn, steps: int,
                  start_step: int = 0):
        from .step_kernels import (flatten_f32, flatten_params, param_size,
                                   unpack_adamw_out)
        if self.arch is None:
            raise ValueError("comm mode needs arch= (a config id "
                             "resolvable by repro_torch.train.step_kernels)")
        comm = self.comm
        p_len = param_size(self.arch, self.arch_reduced)
        pvec = flatten_params(state.params)
        if pvec.shape[0] != p_len:
            raise ValueError(
                f"model/arch mismatch: params flatten to {pvec.shape[0]} "
                f"but arch {self.arch!r} expects {p_len}")
        mu = flatten_f32(state.opt.mu)
        nu = flatten_f32(state.opt.nu)
        step_arr = torch.as_tensor(state.opt.step, dtype=torch.int32)
        _donate(state, (pvec, mu, nu, step_arr))

        cg = slots = None
        cap_epoch = -1
        lead = _lead()
        history = []
        t_last = time.perf_counter()
        for step in range(start_step, start_step + steps):
            t0 = time.perf_counter()
            parts = self._microbatches(data_fn(step))
            out = None
            for attempt in (0, 1):
                if cg is None or comm.epoch != cap_epoch:
                    cap_epoch = comm.epoch
                    cg, slots = self._capture_comm_step(
                        (pvec, mu, nu, step_arr), parts)
                    updates = None
                else:
                    updates = {slots["pvec"]: pvec, slots["mu"]: mu,
                               slots["nu"]: nu, slots["step"]: step_arr}
                    for row, srow in zip(parts, slots["parts"]):
                        for col, scol in zip(row, srow):
                            for arr, slot in zip(col, scol):
                                updates[slot] = arr
                try:
                    out = cg.replay(updates)[-1]
                    break
                except Exception:
                    # §11 repair path: a member died (or the pinned plan
                    # went stale) mid-replay: recapture on the re-bound
                    # group and retry once before surfacing the error
                    if attempt:
                        raise
                    log.warning("comm-step replay failed; recapturing on "
                                "current group %s", list(comm.platforms))
                    cg = None
            new = unpack_adamw_out(out, self.arch, self.arch_reduced)
            # the step's input vectors go, as the reference's donated state
            # does; the compiled graph's capture-time ones with them
            _donate((pvec, mu, nu), out)
            pvec, mu, nu, metrics = new
            step_arr = metrics["step"]
            if self.straggler is not None:
                float(metrics["loss"])          # the step's work, done
            self._observe_straggler(step, time.perf_counter() - t0, lead)
            if self.heartbeat is not None and lead:
                self.heartbeat.beat(step)
            if step % self.log_every == 0 or step == start_step + steps - 1:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                history.append((step, float(metrics["loss"])))
                if lead:
                    log.info("step %5d loss %.4f lr %.2e gnorm %.3f "
                             "[%d members] (%.2fs)", step, float(metrics["loss"]),
                             float(metrics["lr"]), float(metrics["grad_norm"]),
                             comm.size, dt)
            if self.ckpt is not None and step and step % self.ckpt_every == 0:
                self.ckpt.save(step, self._comm_state(pvec, mu, nu, step_arr))
        state = self._comm_state(pvec, mu, nu, step_arr)
        if self.ckpt is not None:
            self.ckpt.save(start_step + steps - 1, state, wait=True)
        return state, history

    def _comm_state(self, pvec, mu, nu, step_arr) -> TrainState:
        """The flat vectors as the single-device trainer's state: the same
        leaves, so a checkpoint of either mode restores into the other."""
        from .step_kernels import unflatten_f32, unflatten_params
        return TrainState(
            params=unflatten_params(pvec, self.arch, self.arch_reduced),
            opt=AdamWState(
                step=torch.as_tensor(step_arr, dtype=torch.int32),
                mu=unflatten_f32(mu, self.arch, self.arch_reduced),
                nu=unflatten_f32(nu, self.arch, self.arch_reduced)))
