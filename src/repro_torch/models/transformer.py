"""Model assembly: stage-stacked decoder stacks — port of
``repro.models.transformer``.

A model is a list of *stages* (see configs.base): each stage runs
``repeats`` stacked copies of a block *pattern*, as a plain loop over the
stacked weights.  Two entry points serve a model:

* ``prefill(params, batch)``            — full-sequence forward → (last-token
                                          logits, decode cache)
* ``prefill_chunk(params, cache, tokens, p0)`` — one chunk of a chunked
  prefill through the decode cache (the paged engine's admission)
* ``decode_step(params, cache, token, pos[, active])`` — one-token serve
  step; ``pos`` may be a per-slot (B,) position vector and ``active`` a
  (B,) slot mask; the cache is updated in place

Parameters are nested dicts, lists and tuples of tensors with the
reference's nesting, so :meth:`Model.params_from_numpy` carries the JAX
package's weights across.  Block kinds: attention (GQA, or MLA with its
latent cache), with a dense or a mixture-of-experts FFN (``models.moe``),
Mamba-2 (``models.ssm``; its cache is O(1) conv and SSM state) and zamba2's
shared attention block, one weight copy in ``params["shared"]`` invoked
where the pattern places it.  The stub frontends take precomputed inputs:
``patch_embed`` puts ``batch["patches"]`` before the token embeddings as a
bidirectional prefix, ``frame_embed`` takes ``batch["frames"]`` and decodes
over (B,1,D) frame embeddings.  Training: ``loss_fn(params, batch)`` —
the forward with each stage repeat recomputed in the backward, the masked
cross-entropy plus MoE's router aux loss, which serving drops.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, AttnConfig, BlockSpec, Stage
from ..core.compute_object import from_numpy
from ..distributed.sharding import ParamSpec, current_context, mesh_context, shard
from .attention import attn_param_specs, gqa_forward, mla_forward
from .layers import embed_tokens, ffn, logits_from_hidden, rms_norm, softmax_xent
from .moe import moe_layer, moe_param_specs
from .ssm import mamba_cache_specs, mamba_forward, mamba_param_specs

PyTree = Any


# ---------------------------------------------------------------------------
# Parameter planning
# ---------------------------------------------------------------------------
def _ffn_specs(d_model: int, d_ff: int, act: str, dtype) -> Dict[str, ParamSpec]:
    s = {
        "wu": ParamSpec((d_model, d_ff), dtype, ("fsdp", "tp")),
        "wd": ParamSpec((d_ff, d_model), dtype, ("tp", "fsdp")),
    }
    if act in ("swiglu", "geglu"):
        s["wg"] = ParamSpec((d_model, d_ff), dtype, ("fsdp", "tp"))
    return s


def _block_specs(cfg: ArchConfig, spec: BlockSpec, dtype) -> Dict[str, Any]:
    d = cfg.d_model
    if spec.kind == "shared_attn":
        return {}                       # weights live in params["shared"]
    if spec.kind == "mamba":
        return {
            "ln": ParamSpec((d,), dtype, (None,), init_kind="ones"),
            "ssm": mamba_param_specs(d, spec.ssm, dtype),
        }
    out: Dict[str, Any] = {
        "ln1": ParamSpec((d,), dtype, (None,), init_kind="ones"),
        "ln2": ParamSpec((d,), dtype, (None,), init_kind="ones"),
        "attn": attn_param_specs(d, spec.attn, dtype),
    }
    if spec.moe is not None:
        out["moe"] = moe_param_specs(d, spec.moe, dtype)
    elif spec.d_ff:
        out["ffn"] = _ffn_specs(d, spec.d_ff, spec.act, dtype)
    return out


def _stack_specs(tree: PyTree, r: int) -> PyTree:
    return pytree.tree_map(
        lambda s: ParamSpec((r, *s.shape), s.dtype, (None, *s.logical),
                            init_kind=s.init_kind), tree)


def param_specs(cfg: ArchConfig) -> PyTree:
    dtype = cfg.activation_dtype()
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, d), dtype, (None, "tp")),
        "unembed": ParamSpec((d, cfg.padded_vocab), dtype, (None, "vocab")),
        "final_norm": ParamSpec((d,), dtype, (None,), init_kind="ones"),
        "stages": [],
    }
    for st in cfg.stages:
        specs["stages"].append(tuple(
            _stack_specs(_block_specs(cfg, b, dtype), st.repeats)
            for b in st.pattern))
    if cfg.shared_attn is not None:
        specs["shared"] = {
            "ln1": ParamSpec((d,), dtype, (None,), init_kind="ones"),
            "ln2": ParamSpec((d,), dtype, (None,), init_kind="ones"),
            "attn": attn_param_specs(d, cfg.shared_attn, dtype),
            "ffn": _ffn_specs(d, cfg.shared_d_ff, "swiglu", dtype),
        }
    return specs


def init_params(cfg: ArchConfig, generator: torch.Generator) -> PyTree:
    """Random weights from ``generator``, on its device: N(0, 1/fan_in) for
    matrices, ones for norm scales, Mamba's a_log = log(1..H) and dt_bias =
    softplus⁻¹ of dt spread over [1e-3, 1e-1] (the reference's
    ``init_params``; the two packages draw different numbers from the same
    seed).  A leaf of three or more axes (a stage's stacked weights) is
    drawn one slab of its leading axis at a time, so the float32 draw
    never holds more than one layer's slab: moonshot's stacked experts,
    17.3 GB in bfloat16, would need 34.7 GB of float32 drawn whole."""
    dev = generator.device

    def materialize(s: ParamSpec):
        if s.init_kind == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if s.init_kind == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init_kind == "a_log":
            base = torch.log(torch.arange(1, s.shape[-1] + 1, dtype=torch.float32,
                                          device=dev))
            return base.expand(s.shape).to(s.dtype).clone()
        if s.init_kind == "dt_bias":
            u = torch.linspace(1e-3, 1e-1, s.shape[-1], device=dev)
            return torch.log(torch.expm1(u)).expand(s.shape).to(s.dtype).clone()
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]

        def draw(shape):
            return (torch.randn(shape, generator=generator, dtype=torch.float32,
                                device=dev) * (fan_in ** -0.5)).to(s.dtype)
        if len(s.shape) < 3:
            return draw(s.shape)
        w = torch.empty(s.shape, dtype=s.dtype, device=dev)
        for i in range(s.shape[0]):
            w[i] = draw(s.shape[1:])
        return w

    return pytree.tree_map(materialize, param_specs(cfg))


def _carry(spec: PyTree, leaf, device, path: str):
    """``leaf`` (numpy) as a tensor on ``device``, checked against ``spec``
    with the same nesting."""
    if isinstance(spec, ParamSpec):
        t = from_numpy(np.array(leaf), device)     # a writable copy
        if tuple(t.shape) != spec.shape or t.dtype != spec.dtype:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{spec.shape} {spec.dtype}")
        return t
    if isinstance(spec, dict):
        if not isinstance(leaf, dict) or set(leaf) != set(spec):
            raise ValueError(f"{path}: keys {sorted(leaf) if isinstance(leaf, dict) else type(leaf)}, "
                             f"expected {sorted(spec)}")
        return {k: _carry(spec[k], leaf[k], device, f"{path}.{k}") for k in spec}
    if not isinstance(leaf, (list, tuple)) or len(leaf) != len(spec):
        raise ValueError(f"{path}: expected a sequence of {len(spec)}")
    return type(spec)(_carry(s, x, device, f"{path}[{i}]")
                      for i, (s, x) in enumerate(zip(spec, leaf)))


# ---------------------------------------------------------------------------
# Cache planning
# ---------------------------------------------------------------------------
def _kv_cache_logical(n_kv: int):
    """Shard KV heads over tp when divisible, else sequence-parallel."""
    ctx = current_context()
    tp = ctx.axis_size(ctx.rules.tp) if ctx.mesh is not None else 1
    if tp > 1 and n_kv % tp == 0:
        return ("batch", "tp", None, None)
    return ("batch", None, "seq", None)


def ring_len(cfg: ArchConfig, a: Optional[AttnConfig], seq: int) -> int:
    """Serving cache length for one attention layer: sliding-window layers
    only attend to the last ``window`` keys, so their decode cache is a
    ring of ``window`` slots — unless a bidirectional prefix must stay."""
    if a is not None and a.window is not None and not cfg.prefix_len:
        return min(seq, a.window)
    return seq


def _block_cache_specs(cfg: ArchConfig, spec: BlockSpec, batch: int,
                       seq: int, dtype):
    """Mamba: (conv_x, conv_bc, ssm) states; MLA: the latent and the rope
    key, (B,S,kv_lora) and (B,S,rope_head_dim); GQA and the shared block
    (an ordinary GQA cache of ``cfg.shared_attn``): (k, v)."""
    if spec.kind == "mamba":
        return mamba_cache_specs(cfg.d_model, spec.ssm, batch, dtype)
    a = cfg.shared_attn if spec.kind == "shared_attn" else spec.attn
    if a.kv_lora:
        return (
            ParamSpec((batch, seq, a.kv_lora), dtype, ("batch", "seq", None)),
            ParamSpec((batch, seq, a.rope_head_dim), dtype, ("batch", "seq", None)),
        )
    shp = (batch, a.n_kv_heads, ring_len(cfg, a, seq), a.head_dim)
    logical = _kv_cache_logical(a.n_kv_heads)
    return (ParamSpec(shp, dtype, logical), ParamSpec(shp, dtype, logical))


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> PyTree:
    dtype = cfg.activation_dtype()
    return [tuple(_stack_specs(_block_cache_specs(cfg, b, batch, seq, dtype),
                               st.repeats) for b in st.pattern)
            for st in cfg.stages]


def init_cache(cfg: ArchConfig, batch: int, seq: int, device="cpu") -> PyTree:
    return pytree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_specs(cfg, batch, seq))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _apply_block(spec: BlockSpec, bp, x, *, cfg: ArchConfig, positions,
                 shared_params=None, cache=None, cache_pos=None, active=None):
    """One block: (x out, MoE's weighted aux loss (0.0 for any other
    block), the block's cache)."""
    if spec.kind == "mamba":
        h = rms_norm(x, bp["ln"], cfg.norm_eps)
        y, nc = mamba_forward(bp["ssm"], h, spec.ssm, cache=cache, active=active)
        return x + y, 0.0, nc
    shared = spec.kind == "shared_attn"
    p = shared_params if shared else bp
    a_cfg = cfg.shared_attn if shared else spec.attn
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if a_cfg.kv_lora:
        att, nc = mla_forward(p["attn"], h, a_cfg, positions=positions,
                              norm_eps=cfg.norm_eps, cache=cache,
                              cache_pos=cache_pos, active=active)
    else:
        att, nc = gqa_forward(p["attn"], h, a_cfg, positions=positions,
                              prefix_len=cfg.prefix_len, cache=cache,
                              cache_pos=cache_pos, active=active)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = 0.0
    if not shared and spec.moe is not None:
        f, aux = moe_layer(bp["moe"], h2, spec.moe, spec.act)
    else:
        f = ffn(p["ffn"], h2, "swiglu" if shared else spec.act)
    return x + f, aux, nc


def _per_repeat(tree, repeats: int) -> List[Any]:
    """A stage's stacked weights as one tree per repeat: each leaf unbound
    along its leading axis once, so the backward stacks the repeats'
    gradients into the leaf's gradient in one pass."""
    leaves, spec = pytree.tree_flatten(tree)
    per = [t.unbind(0) for t in leaves]
    return [pytree.tree_unflatten([u[r] for u in per], spec) for r in range(repeats)]


def _train_body(pattern, bps, x, cfg, positions, shared_params):
    """One repeat of a stage's pattern in train mode: (x, Σ aux)."""
    aux = 0.0
    for spec, bp in zip(pattern, bps):
        x, a, _ = _apply_block(spec, bp, x, cfg=cfg, positions=positions,
                               shared_params=shared_params)
        aux = aux + a
    return x, aux


def _run_stage(st: Stage, sp, x, *, cfg, positions, shared_params=None,
               caches=None, cache_pos=None, active=None, mode: str = "prefill"):
    """The stage's repeats in order; returns (x, Σ aux, caches).  Prefill
    returns each block's cache leaves ((k, v), or Mamba's three states)
    stacked over the repeats; decode updates ``caches`` in place; both
    drop MoE's aux (0.0).  Train sums it, keeps no cache and recomputes
    each repeat in the backward
    (``torch.utils.checkpoint``, the reference's per-layer
    ``jax.checkpoint``), so only the repeats' inputs stay saved.  The
    recompute runs under the mesh context the forward ran under, whatever
    thread runs the backward (on the card, autograd's device thread)."""
    fresh: List[List[tuple]] = [[] for _ in st.pattern]
    layers = [_per_repeat(sp[j], st.repeats) for j in range(len(st.pattern))]
    aux = 0.0
    ctx = current_context()

    def recompute():
        return contextlib.nullcontext(), mesh_context(ctx.mesh, ctx.rules)
    for r in range(st.repeats):
        x = shard(x, "batch", "seq_act", None)
        if mode == "train":
            x, a = checkpoint(_train_body, st.pattern, [lp[r] for lp in layers], x,
                              cfg, positions, shared_params, use_reentrant=False,
                              preserve_rng_state=False, context_fn=recompute)
            aux = aux + a
            continue
        for j, spec in enumerate(st.pattern):
            cj = None if caches is None else tuple(c[r] for c in caches[j])
            x, _, nc = _apply_block(spec, layers[j][r], x, cfg=cfg, positions=positions,
                                    shared_params=shared_params, cache=cj,
                                    cache_pos=cache_pos, active=active)
            fresh[j].append(nc)
    if mode == "prefill":
        return x, aux, tuple(tuple(torch.stack(leaf) for leaf in zip(*per_repeat))
                             for per_repeat in fresh)
    return x, aux, caches


def _embed_inputs(params, batch, cfg: ArchConfig) -> torch.Tensor:
    """The (B,S,D) input of a prefill: token embeddings, with the stub
    frontends' precomputed patch embeddings before them (``patch_embed``,
    a bidirectional prefix) or frame embeddings in their place
    (``frame_embed``)."""
    dtype = cfg.activation_dtype()
    if cfg.frontend == "patch_embed":
        tok = embed_tokens(params["embed"], batch["tokens"]).to(dtype)
        x = torch.cat([batch["patches"].to(dtype), tok], dim=1)
    elif cfg.frontend == "frame_embed":
        x = batch["frames"].to(dtype)
    else:
        x = embed_tokens(params["embed"], batch["tokens"]).to(dtype)
    return shard(x, "batch", None, None)


def _forward(params, x, positions, cfg: ArchConfig, *, caches=None,
             cache_pos=None, active=None, mode="prefill"):
    """(final-normed x, Σ aux over the stages, caches)."""
    aux = 0.0
    new_caches = []
    for i, st in enumerate(cfg.stages):
        x, a, nc = _run_stage(
            st, params["stages"][i], x, cfg=cfg, positions=positions,
            shared_params=params.get("shared"),
            caches=None if caches is None else caches[i],
            cache_pos=cache_pos, active=active, mode=mode)
        aux = aux + a
        new_caches.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, new_caches


def _masked_logits(params, x, cfg: ArchConfig):
    logits = logits_from_hidden(params["unembed"], x)
    if cfg.padded_vocab != cfg.vocab_size:
        tail = torch.where(
            torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size,
            0.0, -1e30).to(logits.dtype)
        logits = logits + tail
    return logits


# ---------------------------------------------------------------------------
# Public model object
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    # -- planning ---------------------------------------------------------
    def param_specs(self) -> PyTree:
        return param_specs(self.cfg)

    def cache_specs(self, batch: int, seq: int) -> PyTree:
        return cache_specs(self.cfg, batch, seq)

    def init(self, generator: torch.Generator) -> PyTree:
        return init_params(self.cfg, generator)

    def init_cache(self, batch: int, seq: int, device="cpu") -> PyTree:
        return init_cache(self.cfg, batch, seq, device)

    def params_from_numpy(self, tree: PyTree, device="cpu") -> PyTree:
        """The reference's ``init_params`` tree, as numpy arrays (bfloat16
        included), → this model's parameters on ``device``.  Every leaf's
        shape and dtype is checked against :meth:`param_specs`."""
        return _carry(param_specs(self.cfg), tree, device, "params")

    # -- training ------------------------------------------------------------
    def loss_fn(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(xent + aux, {"xent", "aux"}) of a train batch: batch["labels"]
        and batch["mask"] (B,S) beside the inputs of :meth:`prefill`.  The
        repeats recompute in the backward; ``patch_embed`` scores the
        positions from the last patch on, one a label."""
        cfg = self.cfg
        x = _embed_inputs(params, batch, cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, aux, _ = _forward(params, x, positions, cfg, mode="train")
        logits = _masked_logits(params, x, cfg)
        labels = batch["labels"]
        if cfg.frontend == "patch_embed":
            np_ = cfg.prefix_len
            logits = logits[:, np_ - 1:np_ - 1 + labels.shape[1]]
        xent, _ = softmax_xent(logits, labels, batch.get("mask"))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=xent.device)
        return xent + aux, {"xent": xent, "aux": aux}

    # -- serving -----------------------------------------------------------
    def prefill(self, params, batch):
        """batch["tokens"] (B,S) (with batch["patches"] (B,P,D) for
        ``patch_embed``; batch["frames"] (B,S,D) in their place for
        ``frame_embed``) → (last-token logits (B,V), caches)."""
        cfg = self.cfg
        x = _embed_inputs(params, batch, cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, _, caches = _forward(params, x, positions, cfg, mode="prefill")
        logits = _masked_logits(params, x[:, -1:], cfg)
        return logits[:, 0], caches

    def supports_chunked_prefill(self) -> bool:
        """True when prompts can be prefilled in multi-token chunks through
        the decode caches.  Attention blocks (GQA ring/full and MLA) accept
        multi-token cache steps; Mamba's cache path is single-token, MoE
        routing is capacity-dependent (expert capacity is sized per call,
        so chunked and whole-prompt prefills route — and drop — tokens
        differently), and stub frontends / prefix-LM configs have no token
        chunking — those serve by whole-prompt admission instead."""
        if self.cfg.frontend != "none" or self.cfg.prefix_len:
            return False
        return all(b.kind != "mamba" and b.moe is None
                   for st in self.cfg.stages for b in st.pattern)

    def prefill_chunk(self, params, caches, tokens, p0
                      ) -> Tuple[torch.Tensor, PyTree]:
        """One prefill chunk through the decode caches.

        ``tokens`` (B, C) continues each lane's prompt at positions
        ``p0..p0+C-1`` (``p0`` scalar or (B,)); every attention cache is
        updated in place (ring slots included) and the returned logits
        (B,V) are the chunk's *last* token's — only the final chunk of a
        prompt is sampled.  Callers gate on
        :meth:`supports_chunked_prefill`."""
        cfg = self.cfg
        x = shard(embed_tokens(params["embed"], tokens).to(cfg.activation_dtype()),
                  "batch", None, None)
        b, c = tokens.shape
        pos = torch.as_tensor(p0, dtype=torch.long, device=x.device)
        if pos.dim() == 0:
            pos = pos.expand(b)
        positions = pos[:, None] + torch.arange(c, device=x.device)[None, :]
        x, _, caches = _forward(params, x, positions, cfg, caches=caches,
                                cache_pos=pos, mode="decode")
        logits = _masked_logits(params, x[:, -1:], cfg)
        return logits[:, 0], caches

    def decode_step(self, params, caches, token, pos, active=None):
        """token (B,1) int, or (B,1,D) frame embeddings for ``frame_embed``;
        ``pos`` a scalar (every lane writes the same cache slot) or a (B,)
        vector of per-slot write positions; ``active`` an optional (B,)
        bool slot mask — inactive lanes write nothing, so free slots never
        corrupt the slot-indexed cache.  The cache is updated in place and
        returned."""
        cfg = self.cfg
        if cfg.frontend == "frame_embed":
            x = token.to(cfg.activation_dtype())
        else:
            x = embed_tokens(params["embed"], token).to(cfg.activation_dtype())
        b = x.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
        if pos.dim() == 0:
            pos = pos.expand(b)
        x, _, caches = _forward(params, x, pos[:, None], cfg, caches=caches,
                                cache_pos=pos, active=active, mode="decode")
        logits = _masked_logits(params, x, cfg)
        return logits[:, 0], caches


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
