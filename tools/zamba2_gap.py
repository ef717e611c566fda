"""Where the zamba2 leg's bfloat16 gap against the plain replay comes from.

Run from the repository's root on a machine with an H100:

    python3 tools/zamba2_gap.py          # the study below
    python3 tools/zamba2_gap.py --leg    # chip_smoke.py's zamba2 leg alone

The study builds the kernels and the zamba2 leg's model, weights and
2048-token prompt (``chip_smoke.SERVE_HYBRID``, the same seed), and prints
the normwise gap between the prefill's logits of two bfloat16 runs:

* kernels vs plain versions, with the first k blocks kept (``DEPTHS``);
* at full depth, the kernels with SSD on its plain scan vs plain (the
  kernels' share), and the kernels vs that (the chunked SSD's share);
* two controls, plain vs plain with MMM's plain version summing over K in
  two float32 halves before its one rounding to bfloat16: at its first call
  only (the first Mamba layer's first projection), and at every call.  That
  moves a few of a call's outputs by one bfloat16 ulp, as a kernel's other
  summation order does, and is no fault: the first control's gap at full
  depth is what one rounding change grows to, the second's what another
  summation order in every projection grows to.

``--leg`` runs ``chip_smoke.phase3b_hybrid`` alone, with its checks, so a
change to the served path can be tried against the leg's bounds without the
rest of the smoke.  The last line is a JSON object of the readings.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

#: blocks kept, in the order they run (44 is zamba2-1.2b's full depth)
DEPTHS = (1, 2, 7, 14, 28, 44)


def planted_registry(every: bool):
    """``chip_smoke.wrapped_registry`` with MMM's torch row computing over K
    in two float32 halves at its first call (``every``: at every call);
    returns (registry, a list that gets the share of each changed call's
    outputs the change moved)."""
    moved = []

    def wrap(rec):
        if (rec.alias, rec.platform) != ("MMM", "torch"):
            return None

        def split_k(a, b, _fn=rec.fn):
            out = _fn(a, b)
            if moved and not every:
                return out
            h = a.shape[-1] // 2
            other = (a[..., :h].float() @ b[:h].float()
                     + a[..., h:].float() @ b[h:].float()).to(a.dtype)
            moved.append(float((other != out).float().mean()))
            return other
        return split_k
    return smoke.wrapped_registry(wrap), moved


def study(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import default_manifest
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.kernels import register_all
    from repro_torch.models import build_model

    leg = smoke.SERVE_HYBRID
    cfg = get_config(leg["arch"])
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(leg["seed"])
    params = model.init(gen)
    lens = leg["prompt_lens"]
    prompts = [torch.randint(0, cfg.vocab_size, (lens[i % len(lens)],), generator=gen,
                             device=dev).tolist() for i in range(leg["requests"])]
    prompt = prompts[lens.index(max(lens))]
    max_len = max(lens) + leg["max_new"] + 8
    blocks = sum(len(st.pattern) * st.repeats for st in cfg.stages)
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]

    def prefill(m, p, manifest, registry=None):
        return smoke.replay(m, p, prompt, [0], max_len, manifest, registry)[0]

    depth, full = {}, {}
    for k in DEPTHS:
        cut, sliced = smoke.first_blocks(cfg, params, min(k, blocks))
        mc = build_model(cut)
        kern, ref = prefill(mc, sliced, None), prefill(mc, sliced, plain)
        depth[k] = smoke.normwise(kern, ref)
        if k >= blocks:
            full = {"kernels": kern, "plain": ref}
    scan_only = KernelRegistry()
    register_all(scan_only)
    scan_only.deregister("SSD", "aten")
    ssd_scan = prefill(model, params, None, scan_only)
    controls = {}
    for every in (False, True):
        planted, moved = planted_registry(every)
        controls[every] = (prefill(model, params, plain, planted), moved)
    out = {"blocks": blocks, "bf16_gap_by_depth": depth,
           "ssd_scan_vs_plain": smoke.normwise(ssd_scan, full["plain"]),
           "kernels_vs_ssd_scan": smoke.normwise(full["kernels"], ssd_scan),
           "control_first_call_vs_plain": smoke.normwise(controls[False][0], full["plain"]),
           "control_first_call_moved": controls[False][1][0],
           "control_every_call_vs_plain": smoke.normwise(controls[True][0], full["plain"]),
           "control_every_call_moved_mean": sum(controls[True][1]) / len(controls[True][1]),
           "control_every_call_calls": len(controls[True][1])}
    print(f"  {cfg.name}, bfloat16 prefill gap of the {len(prompt)}-token request, "
          f"kernels vs plain, by blocks kept: "
          + ", ".join(f"{k}: {e:.2e}" for k, e in depth.items()))
    print(f"  at {blocks} blocks: kernels with SSD on its scan vs plain "
          f"{out['ssd_scan_vs_plain']:.2e}; kernels vs that {out['kernels_vs_ssd_scan']:.2e}")
    print(f"  controls, plain vs plain with MMM's plain version summed over K in two "
          f"halves: at its first call ({out['control_first_call_moved']:.4%} of its "
          f"outputs moved) {out['control_first_call_vs_plain']:.2e}; at all "
          f"{out['control_every_call_calls']} calls ({out['control_every_call_moved_mean']:.4%}"
          f" moved, mean) {out['control_every_call_vs_plain']:.2e}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", action="store_true",
                    help="run chip_smoke.py's zamba2 leg alone, with its checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is False: this script needs the card")
    from repro_torch.kernels import _cuda

    _cuda.build()
    _cuda.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(smoke.card_line())
    if args.leg:
        _, out = smoke.phase3b_hybrid(dev)
    else:
        out = study(dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
