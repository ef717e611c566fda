"""Registry-resident training-step kernels — port of
``repro.train.step_kernels``.

Data-parallel training through the C²MPI collectives needs the
forward/backward and the optimizer step to be *registry aliases*, not host
closures: device-group members resolve aliases in their own registries,
and a closure over a live ``Model`` cannot cross the wire.  Two builtins:

* ``LM_GRAD(params_vec, tokens, labels, mask, arch=…, reduced=…)`` —
  one microbatch's loss + gradients as a single float32 vector
  ``concat([loss], grads_flat)``, so the whole backward result rides a
  reduce tree as one payload.
* ``ADAMW_STEP(gsum_vec, params_vec, mu_vec, nu_vec, step, …hyper)`` —
  consumes the *summed* microbatch vector (dividing by ``n_micro`` exactly
  once), applies clip + AdamW + schedule, and returns
  ``concat(new_params, new_mu, new_nu, [step, loss, lr, grad_norm])``.

The torch, aten and hopper rows of each share ONE callable, as the
reference's three rows do.  Parameters travel as a flat float32 vector in
``jax.tree``'s leaf order (bfloat16 → float32 → bfloat16 is lossless),
unflattened from the arch's cached template.  ``arch`` is a config id
resolved by :func:`repro_torch.configs.get_config`, or ``"<id>@<L>"``,
that config cut to ``L`` layers (one-stage configs only): a name every
process resolves alike, so a worker process (DESIGN.md §13) runs the same
cut as its host.  Other in-process custom configs register with
:func:`register_arch` (this process only).  The trainer's comm mode
(``train/trainer.py``) dispatches ``LM_GRAD`` on every member of a device
group and one ``ADAMW_STEP``; ``LM_GRAD``'s own dispatches (MMM, RMSNORM,
FLASH_ATTN, EMBED_GRAD) run on the calling member's worker thread through
the process's session, so they take the same rows on every member, and
each of those repeats bit for bit on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

from ..configs import get_config
from ..configs.base import ArchConfig
from ..core.tree import tree_flatten, tree_leaves, tree_unflatten
from ..models import build_model
from ..optim.adamw import AdamWState, adamw_update
from ..optim.schedule import linear_warmup_cosine
from .trainer import loss_and_grads

__all__ = ["adamw_step_vec", "flatten_f32", "flatten_params", "lm_grad_vec",
           "param_size", "register_arch", "resolve_arch", "unflatten_f32",
           "unflatten_params", "unpack_adamw_out"]

#: in-process custom configs (take precedence over the built-in registry)
_EXTRA_ARCHES: Dict[str, ArchConfig] = {}


def register_arch(name: str, cfg: ArchConfig) -> None:
    """Make a non-registry :class:`ArchConfig` resolvable as ``arch=name``
    (this process only)."""
    _EXTRA_ARCHES[name] = cfg
    _model_of.cache_clear()
    _template.cache_clear()


def resolve_arch(arch: str, reduced: bool = False) -> ArchConfig:
    cfg = _EXTRA_ARCHES.get(arch) or _depth_cut(arch)
    return cfg.reduced() if reduced else cfg


def _depth_cut(arch: str) -> ArchConfig:
    """``get_config(arch)``, or for ``"<id>@<L>"`` that config with its one
    stage cut to ``L`` repeats."""
    base, sep, layers = arch.rpartition("@")
    if not sep:
        return get_config(arch)
    cfg = get_config(base)
    if len(cfg.stages) != 1 or not layers.isdigit() or int(layers) < 1:
        raise KeyError(f"arch {arch!r}: a depth cut names a one-stage config "
                       f"and a layer count >= 1")
    return dataclasses.replace(cfg, stages=(dataclasses.replace(
        cfg.stages[0], repeats=int(layers)),))


@functools.lru_cache(maxsize=None)
def _model_of(arch: str, reduced: bool):
    return build_model(resolve_arch(arch, reduced))


@functools.lru_cache(maxsize=None)
def _template(arch: str, reduced: bool):
    """(spec, shapes, dtypes, offsets, total) of the arch's params, from its
    parameter specs (nothing allocated)."""
    specs, spec = tree_flatten(_model_of(arch, reduced).param_specs())
    shapes = tuple(tuple(s.shape) for s in specs)
    dtypes = tuple(s.dtype for s in specs)
    offsets, off = [], 0
    for shp in shapes:
        offsets.append(off)
        off += math.prod(shp)
    return spec, shapes, dtypes, tuple(offsets), off


def param_size(arch: str, reduced: bool = False) -> int:
    """Flat-vector length of the arch's parameters (= moment length)."""
    return _template(arch, reduced)[4]


# ---------------------------------------------------------------------------
# Flatten / unflatten
# ---------------------------------------------------------------------------
def flatten_params(params, out=None) -> torch.Tensor:
    """Param tree → one float32 vector (leaf order = ``jax.tree.flatten``),
    each leaf copied into its slice of ``out`` (allocated when None): no
    float32 copy of a leaf is made on the way, so a flattening holds one
    vector at a time."""
    leaves = tree_leaves(params)
    if out is None:
        out = torch.empty(sum(l.numel() for l in leaves), dtype=torch.float32,
                          device=leaves[0].device if leaves else "cpu")
    off = 0
    for leaf in leaves:
        out[off:off + leaf.numel()].copy_(leaf.reshape(-1))
        off += leaf.numel()
    return out


flatten_f32 = flatten_params    # moments are float32 trees of the same shapes


def _split(vec, arch: str, reduced: bool):
    spec, shapes, dtypes, offsets, _ = _template(arch, reduced)
    parts = [vec[off:off + math.prod(s)].reshape(s) for s, off in zip(shapes, offsets)]
    return spec, dtypes, parts


def unflatten_params(vec, arch: str, reduced: bool = False):
    """float32 vector → param tree at the arch's native leaf dtypes."""
    spec, dtypes, parts = _split(vec, arch, reduced)
    return tree_unflatten(spec, [p.to(dt) for p, dt in zip(parts, dtypes)])


def unflatten_f32(vec, arch: str, reduced: bool = False):
    """float32 vector → tree with param shapes but float32 leaves (grads,
    moments)."""
    spec, _, parts = _split(vec, arch, reduced)
    return tree_unflatten(spec, parts)


# ---------------------------------------------------------------------------
# LM_GRAD
# ---------------------------------------------------------------------------
def lm_grad_vec(params_vec, tokens, labels, mask, *, arch: str,
                reduced: bool = False) -> torch.Tensor:
    """One microbatch forward/backward: ``concat([loss], grads_flat)``
    float32, on the parameter vector's device."""
    model = _model_of(arch, bool(reduced))
    if model.cfg.frontend != "none":
        raise ValueError(
            f"LM_GRAD supports token-frontend archs only; {arch!r} uses "
            f"frontend={model.cfg.frontend!r}")
    params_vec = torch.as_tensor(params_vec, dtype=torch.float32)
    dev = params_vec.device
    params = unflatten_params(params_vec, arch, bool(reduced))
    batch = {"tokens": torch.as_tensor(tokens, device=dev),
             "labels": torch.as_tensor(labels, device=dev),
             "mask": torch.as_tensor(mask, device=dev)}
    loss, _, grads = loss_and_grads(model, params, batch)
    del params
    out = torch.empty(1 + param_size(arch, bool(reduced)), dtype=torch.float32, device=dev)
    out[0] = loss
    flatten_f32(grads, out=out[1:])
    return out


# ---------------------------------------------------------------------------
# ADAMW_STEP
# ---------------------------------------------------------------------------
def adamw_step_vec(gsum_vec, params_vec, mu_vec, nu_vec, step, *, arch: str,
                   reduced: bool = False, n_micro: int = 1,
                   base_lr: float = 3e-4, warmup_steps: int = 100,
                   total_steps: int = 1_000, weight_decay: float = 0.1,
                   clip_norm: float = 1.0) -> torch.Tensor:
    """AdamW over a summed ``LM_GRAD`` vector.

    Returns ``concat(new_params, new_mu, new_nu, [step, loss, lr, gnorm])``
    — slice at ``param_size(arch, reduced)`` boundaries host-side."""
    reduced = bool(reduced)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    gsum_vec, params_vec = f32(gsum_vec), f32(params_vec)
    mu_vec, nu_vec = f32(mu_vec), f32(nu_vec)
    step = torch.as_tensor(step, dtype=torch.int32, device=params_vec.device)
    with torch.no_grad():
        # the microbatch mean is taken exactly once, here — members only
        # ever sum, so the reduce tree stays pure EWADD
        loss = gsum_vec[0] / n_micro
        grads = unflatten_f32(gsum_vec[1:] / n_micro, arch, reduced)
        params = unflatten_params(params_vec, arch, reduced)
        mu = unflatten_f32(mu_vec, arch, reduced)
        nu = unflatten_f32(nu_vec, arch, reduced)
        lr = linear_warmup_cosine(step, base_lr=float(base_lr),
                                  warmup_steps=int(warmup_steps),
                                  total_steps=int(total_steps))
        new_p, st, om = adamw_update(params, grads, AdamWState(step, mu, nu),
                                     lr=lr, weight_decay=float(weight_decay),
                                     clip_norm=float(clip_norm))
        del grads, params, mu, nu          # the output takes their room
        p = param_size(arch, reduced)
        out = torch.empty(3 * p + 4, dtype=torch.float32, device=params_vec.device)
        flatten_params(new_p, out=out[:p])
        del new_p
        flatten_f32(st.mu, out=out[p:2 * p])
        flatten_f32(st.nu, out=out[2 * p:3 * p])
        out[3 * p:] = torch.stack([st.step.to(torch.float32), loss,
                                   lr.to(torch.float32), om["grad_norm"]])
        return out


def unpack_adamw_out(out, arch: str, reduced: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Host-side view of an ``ADAMW_STEP`` result: (params_vec, mu_vec,
    nu_vec, {"step", "loss", "lr", "grad_norm"})."""
    p = param_size(arch, reduced)
    tail = out[3 * p:]
    metrics = {"step": tail[0].to(torch.int32), "loss": tail[1],
               "lr": tail[2], "grad_norm": tail[3]}
    return out[:p], out[p:2 * p], out[2 * p:3 * p], metrics
