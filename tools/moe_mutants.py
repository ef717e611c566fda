"""The MoE and MLA legs' mutation check, and those legs alone.

Run from the repository's root on a machine with an H100:

    python3 tools/moe_mutants.py                      # every mutant
    python3 tools/moe_mutants.py --phases phase2,mla  # chip_smoke.py's parts

``--phases`` builds the kernels and runs, in order, any of
``chip_smoke.phase2_moe_mla`` ("phase2"), ``phase3b_moe`` ("moe", the
moonshot leg) and ``phase3b_mla`` ("mla", the deepseek leg), with their
checks; a failed check exits non-zero with chip_smoke's message.

Without it, each mutant of ``MUTANTS`` is written into a copy of the tree
under the gitignored ``build/mutants/`` and, in that copy, phase2 and the
deepseek leg run (the leg alone for a decode-only mutant, which phase 2
does not reach), then the card tests of the MoE and padded FLASH_ATTN
paths.  Each mutant must fail one of them; the last line is a JSON object
of what each run reported, and the exit code is non-zero if a mutant
passed everything.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: name → (file, the line as it is, the line as the mutant has it)
MUTANTS = {
    "gates_not_renormalised": (
        "src/repro_torch/models/moe.py",
        "gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)",
        "gates = gates"),
    "shared_expert_dropped": (
        "src/repro_torch/models/moe.py",
        'y_sh = dense(act_fn("swiglu", g, u), p["ws_d"])',
        'y_sh = dense(act_fn("swiglu", g, u)[..., :m.d_ff_expert].contiguous(), '
        'p["ws_d"][:m.d_ff_expert])'),
    "expert_down_skipped": (
        "src/repro_torch/kernels/moe_ffn/ops.py",
        "    return torch.bmm(act, w_down)",
        "    y = torch.bmm(act, w_down)\n    y[0] = 0\n    return y"),
    "mla_scale_256": (
        "src/repro_torch/kernels/flash_attention/flash_attention.py",
        "scale = float(q.shape[-1] ** -0.5)",
        "scale = float(padded_head_dim(q.shape[-1]) ** -0.5)"),
    "mla_decode_no_rope": (
        "src/repro_torch/models/attention.py",
        "scores = (s_lat + s_rope) * (dh + rdh) ** -0.5",
        "scores = s_lat * (dh + rdh) ** -0.5"),
}
#: the card tests of the paths the mutants touch
CARD_TESTS = "padded_head_dim or mla_prefill_shape or moe"


def run_phases(phases) -> None:
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.kernels import _cuda

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is False: this needs the card")
    _cuda.build()
    _cuda.lib()
    print(f"card: {smoke.card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for what in phases:
        if what == "phase2":
            smoke.phase2_moe_mla(dev, torch.Generator(device=dev).manual_seed(0))
        else:
            _, stats = {"moe": smoke.phase3b_moe, "mla": smoke.phase3b_mla}[what](dev)
            print(json.dumps({f"serve_{what}": stats}))
        torch.cuda.empty_cache()


def verdict(cmd, cwd) -> str:
    """Run ``cmd`` in ``cwd``: "passed", or its first failure line."""
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=1200,
                       env={**os.environ, "PYTHONPATH": "src"})
    lines = (p.stdout + p.stderr).splitlines()
    for line in lines:
        if "err " in line or "worst" in line or line.startswith("FAILED"):
            print("    " + line[:300])
    if p.returncode == 0:
        return "passed"
    failed = [l for l in lines if "chip_smoke FAILED" in l or l.startswith("FAILED")]
    return "; ".join(l[:240] for l in failed[:4]) or f"exit {p.returncode}"


def mutants() -> int:
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import _cuda
    _cuda.build()                      # the copies reuse it: no source of it changes
    out = {}
    for name, (path, old, new) in MUTANTS.items():
        dst = ROOT / "build" / "mutants" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(".git", "build"))
        f = dst / path
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"mutant {name}: {path} does not hold {old!r} once")
        f.write_text(text.replace(old, new))
        print(f"=== {name}: {path}", flush=True)
        res = {}
        for phase in (("mla",) if name == "mla_decode_no_rope" else ("phase2", "mla")):
            res[phase] = verdict([sys.executable, "tools/moe_mutants.py", "--phases", phase],
                                 dst)
            print(f"  {phase}: {res[phase]}", flush=True)
        res["card_tests"] = verdict([sys.executable, "-m", "pytest", "-q", "--noconftest",
                                     "-m", "cuda", "tests/test_torch_cuda.py", "-k",
                                     CARD_TESTS], dst)
        print(f"  card tests: {res['card_tests']}", flush=True)
        out[name] = res
        shutil.rmtree(dst, ignore_errors=True)
    caught = {n: any(v != "passed" for v in r.values()) for n, r in out.items()}
    print(json.dumps({"mutants": out, "caught": caught}))
    return 0 if all(caught.values()) else 1


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", help="comma-separated: phase2, moe, mla")
    args = ap.parse_args()
    if args.phases:
        run_phases(args.phases.split(","))
        return
    raise SystemExit(mutants())


if __name__ == "__main__":
    main()
