"""Training loop: grad accumulation, per-layer recompute, optional int8
gradient compression, checkpoint/restart, heartbeat — port of
``repro.train.trainer``.

A train step is loss (each stage repeat recomputed in the backward,
``Model.loss_fn``) → grads (``torch.autograd`` through the MMM, RMSNORM
and FLASH_ATTN rows' ``autograd.Function``s) → optional quantize and
dequantize with error feedback → AdamW with the warmup-cosine schedule.
It runs eagerly on the session's device, one device.

The reference's data-parallel mode (``comm=``: LM_GRAD per member, an
EWADD reduce tree, ``iallreduce``, one ADAMW_STEP, replayed as a compiled
graph) is A10's data-parallel half; ``comm=`` raises until ROADMAP A10b
lands (the collectives it runs on are ported).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..models.transformer import Model
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..optim.compression import compress_gradients, decompress_gradients
from ..optim.schedule import linear_warmup_cosine
from .checkpoint import CheckpointManager
from .fault_tolerance import HeartbeatJournal, StragglerPolicy

log = logging.getLogger("repro_torch.train")
PyTree = Any

#: the refusal of the data-parallel mode, A10's half still to port
COMM_REFUSAL = ("data-parallel training over a device group (comm=) is A10's "
                "data-parallel half, which the port has not yet (its "
                "collectives are ported): ROADMAP A10b")


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


def _donate(old: TrainState, new: TrainState) -> None:
    """Free ``old``'s tensors once ``new`` exists: the reference's step
    donates its input state (``donate_argnums``), so a full-depth run holds
    two states at a time, not three (the caller's first state stays alive
    otherwise).  A tensor whose storage ``new`` still uses is kept, and so
    is one on memory torch does not own (a numpy array's)."""
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

    ``straggler`` (when set) observes every step's wall time; straggler
    events are logged with the policy's recommendation.  ``comm`` (the
    reference's data-parallel mode) raises: ROADMAP A10b."""
    model: Model
    hp: TrainHyper
    ckpt: Optional[CheckpointManager] = None
    heartbeat: Optional[HeartbeatJournal] = None
    straggler: Optional[StragglerPolicy] = None
    comm: Optional[Any] = None
    log_every: int = 10
    ckpt_every: int = 50

    def __post_init__(self):
        if self.comm is not None:
            raise ValueError(COMM_REFUSAL)

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

    def _observe_straggler(self, step: int, dt: float) -> None:
        if self.straggler is not None and self.straggler.observe(dt):
            log.warning("step %d straggler: %.2fs vs median %.2fs (%s)",
                        step, dt, self.straggler.median(),
                        self.straggler.recommendation())

    def run(self, state: TrainState, data_fn: Callable[[int], Any],
            steps: int, start_step: int = 0):
        """``steps`` steps from ``start_step``; returns (state, [(step,
        loss)]) with a loss every ``log_every`` steps and at the last.  The
        state passed in is donated, as in the reference: its tensors are
        freed after the first step."""
        step_fn = make_train_step(self.model, self.hp)
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
            self._observe_straggler(step, time.perf_counter() - t0)
            if self.heartbeat is not None:
                self.heartbeat.beat(step)
            if step % self.log_every == 0 or step == start_step + steps - 1:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                history.append((step, float(metrics["loss"])))
                log.info("step %5d loss %.4f lr %.2e gnorm %.3f (%.2fs)",
                         step, float(metrics["loss"]), float(metrics["lr"]),
                         float(metrics["grad_norm"]), dt)
            if self.ckpt is not None and step and step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        if self.ckpt is not None:
            self.ckpt.save(start_step + steps - 1, state, wait=True)
        return state, history
