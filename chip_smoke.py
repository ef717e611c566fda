"""Chip smoke test: build the port's Hopper kernels and drive the port on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. Build the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   in parallel); print the card and its power limit; turn TF32 off.
2. Hold each kernel (each EW op) against its plain PyTorch version on the
   card, in float32 and bfloat16, at ragged shapes and at the shapes of
   phase 3.  EW*: bit-exact.  MMM, MVM: normwise relative error, see
   ``TOL``.  VDP: bit-exact on integer vectors whose sum every order gets
   exactly, and relative error (``VDP_TOL``) on vectors of mean 1.
3. The slice end to end: ``repro_torch.quickstart.run`` on ``cuda`` with
   every claim pinned to the hopper records, blocking and asynchronous, at
   working sets inside the paper's 48 MB–1 GB.  Every kernel's launch count
   must rise by exactly the requests sent to it, the scheduler's quarantine
   must stay empty, and every output must match its plain version.  Then
   the template is timed end to end (median of 5 runs, T1 per call).
4. Times at the phase-3 shapes: the median of 20 CUDA-event-timed calls of
   the kernel, its plain version and one library call, beside the least
   time the card could take (``bound_ms``).

It prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: working sets of phase 3 (paper's 48 MB–1 GB range)
SIZES = {"MMM": 4096, "EW": 8192, "MVM": 8192, "VDP": 1 << 26}

#: MMM and MVM: normwise relative error allowed between a kernel and its
#: plain version.  float32: the two sum the same float32 products in another
#: order, which moves the result by a few units of 2^-24 times sqrt(K); 1e-5
#: leaves room for K = 8192.  bfloat16: the float32 sums are alike, but
#: rounding the output to an 8-bit mantissa (2^-9 ≈ 2e-3 relative) can land
#: on the other side for some elements.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

#: VDP: |k − r| / |r| on vectors of mean 1, where Σxy ≈ n is about half of
#: ‖x‖‖y‖, so this is the dot product's own relative error.  The output is
#: float32 and bfloat16 products are exact in float32, so both types differ
#: only in summation order: a chain of d float32 additions errs by about
#: sqrt(d)·2^-24 · Σ|xy|/|Σxy| (≈ 1.4 here) when its rounding errors are
#: random; the kernel's longest chain at n = 2^26 is ~270 additions, which
#: gives ~1.4e-6.  1e-5 leaves room, and still catches one pass-1 block of
#: the 1024 left out (~1e-3).  The integer cases of ``vdp_exact_inputs`` are
#: held bit-exact instead.
VDP_TOL = 1e-5

#: published peaks (NVIDIA data sheets, dense): bytes/s, float32 CUDA-core
#: FLOP/s, bfloat16 tensor-core FLOP/s
PEAKS = {"H100 SXM": (3.35e12, 67e12, 989e12),
         "H100 PCIe": (2.0e12, 51e12, 756e12)}

TIMED_RUNS = 20
E2E_REPEATS = 5
PIN = {"allowed_platforms": ["hopper"]}

REPLACES = {
    "mmm": "src/repro/kernels/matmul/matmul.py:43",
    "ewise": "src/repro/kernels/ewise/ewise.py:33",
    "mvm": "src/repro/kernels/mvm/mvm.py:42",
    "vdp": "src/repro/kernels/vdp/vdp.py:33",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return key, PEAKS[key]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------
def normwise(k: torch.Tensor, r: torch.Tensor) -> float:
    k, r = k.double(), r.double()
    return float((k - r).norm() / r.norm().clamp_min(1e-300))


def relative(k: torch.Tensor, r: torch.Tensor) -> float:
    """|k − r| / |r| of two scalars."""
    k, r = k.double(), r.double()
    return float((k - r).abs() / r.abs().clamp_min(1e-300))


def vdp_exact_inputs(n: int, dtype, gen, dev):
    """Integer vectors whose dot product every summation order gets exactly.

    x ∈ {0, 1, 2} (nonzero with density min(1, 2^22/n)), y ∈ {1, 2}: every
    product is a small integer, Σxy < 2^24 (checked), so every partial sum
    is an integer that float32 holds exactly.  The kernel must then give the
    plain version's bits and the exact sum; where x is dense, each element
    dropped or counted twice moves the result by at least 1."""
    def bern(p):
        return (torch.rand(n, generator=gen, device=dev) < p).float()
    x = bern(min(1.0, 2.0 ** 22 / n)) * (1 + bern(0.5))
    y = 1 + bern(0.5)
    exact = float((x.double() * y.double()).sum())
    if not exact < 2 ** 24:
        fail(f"VDP exact case n={n}: Σxy = {exact} is not below 2^24")
    return x.to(dtype), y.to(dtype), exact


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_close(what: str, err: float, dtype, tol=None) -> None:
    tol = TOL[dtype] if tol is None else tol
    print(f"  {what:42s} err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        fail(f"{what}: error {err:.3e} exceeds {tol:g}")


def check_bits(what: str, k: torch.Tensor, r: torch.Tensor) -> None:
    same = k.shape == r.shape and k.dtype == r.dtype and torch.equal(bits(k), bits(r))
    print(f"  {what:42s} bit-exact {same}")
    if not same:
        diff = int((bits(k) != bits(r)).sum()) if k.shape == r.shape else -1
        fail(f"{what}: not bit-identical to the plain version ({diff} differ)")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def phase2(dev) -> None:
    from repro_torch.kernels.ewise.ewise import ewise_hopper
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.matmul.matmul import mmm_hopper
    from repro_torch.kernels.matmul.ref import mmm_ref
    from repro_torch.kernels.mvm.mvm import mvm_hopper
    from repro_torch.kernels.mvm.ref import mvm_ref
    from repro_torch.kernels.vdp.ref import vdp_ref
    from repro_torch.kernels.vdp.vdp import vdp_hopper

    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, dtype, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) + shift).to(dtype)

    n_ew, n_mmm, n_mvm, n_vdp = SIZES["EW"], SIZES["MMM"], SIZES["MVM"], SIZES["VDP"]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        for m, k, n in ((1000, 777, 1001), (1, 5, 3), (n_mmm, n_mmm, n_mmm)):
            a, b = rnd(m, k, dtype=dt), rnd(k, n, dtype=dt)
            check_close(f"MMM {name} {m}x{k}@{k}x{n}",
                        normwise(mmm_hopper(a, b), mmm_ref(a, b)), dt)
        ew_cases = [("1000x777", rnd(1000, 777, dtype=dt),
                     rnd(1000, 777, dtype=dt, shift=3.0)),
                    (f"{n_ew}x{n_ew}", rnd(n_ew, n_ew, dtype=dt),
                     rnd(n_ew, n_ew, dtype=dt, shift=3.0))]
        # offset views: pointers off the 16-byte grid take the scalar path
        flat_a, flat_b = rnd(100_003, dtype=dt), rnd(100_003, dtype=dt, shift=3.0)
        ew_cases.append(("unaligned 100002", flat_a[1:], flat_b[1:]))
        for label, a, b in ew_cases:
            for op, ref in EW_REFS.items():
                check_bits(f"EW {op} {name} {label}", ewise_hopper(a, b, op), ref(a, b))
        for m, k in ((1000, 777), (1000, 776), (n_mvm, n_mvm)):
            a, x = rnd(m, k, dtype=dt), rnd(k, dtype=dt)
            check_close(f"MVM {name} {m}x{k}", normwise(mvm_hopper(a, x), mvm_ref(a, x)), dt)
        for n in (1, 4099, 1_000_003, n_vdp):
            x, y, exact = vdp_exact_inputs(n, dt, gen, dev)
            k = vdp_hopper(x, y)
            check_bits(f"VDP {name} n={n} integers", k, vdp_ref(x, y))
            if float(k) != exact:
                fail(f"VDP {name} n={n}: {float(k)} != exact sum {exact}")
        for n in (1_000_003, n_vdp):
            x, y = rnd(n, dtype=dt, shift=1.0), rnd(n, dtype=dt, shift=1.0)
            check_close(f"VDP {name} n={n} mean 1",
                        relative(vdp_hopper(x, y), vdp_ref(x, y)), dt, VDP_TOL)
        x, y = rnd(1_000_003, dtype=dt), rnd(1_000_003, dtype=dt)
        first = vdp_hopper(x, y)
        if not all(torch.equal(first, vdp_hopper(x, y)) for _ in range(3)):
            fail(f"VDP {name}: repeated calls differ (expected the same bits)")
        print(f"  VDP {name} repeated calls give the same bits")
    torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# phase 3: the slice end to end through the port's host API
# ---------------------------------------------------------------------------
def phase3(dev):
    from repro_torch import halo, quickstart
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.matmul.ref import mmm_ref
    from repro_torch.kernels.mvm.ref import mvm_ref
    from repro_torch.kernels.vdp.ref import vdp_ref

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    jobs = quickstart.make_jobs(SIZES, dev, seed=0)
    torch.cuda.synchronize(dev)
    _cuda.reset_launch_counts()
    session.reset_t1()
    t0 = time.perf_counter()
    sync, asyn = quickstart.run(jobs, overrides=PIN)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    quarantined = session.scheduler.failed_record_keys()
    print(f"  quickstart (sync + async) on {session.device}: {wall:.3f} s wall, "
          f"T1 {session.t1_seconds_per_call * 1e6:.1f} us per call over "
          f"{2 * len(jobs)} calls")
    print(f"  launches {launches}; quarantine {quarantined}")
    expected = {"mmm": 2, "ewise": 8, "mvm": 2, "vdp": 2}
    if launches != expected:
        fail(f"launch counts {launches} != requests sent {expected}: a request "
             f"did not reach its kernel")
    if quarantined:
        fail(f"records were quarantined on the main path: {quarantined}")

    refs = {"MMM": mmm_ref, "EWMM": EW_REFS["mul"], "EWMD": EW_REFS["div"],
            "EWADD": EW_REFS["add"], "EWSUB": EW_REFS["sub"], "MVM": mvm_ref,
            "VDP": vdp_ref}
    kernel_of = {"MMM": "mmm", "MVM": "mvm", "VDP": "vdp"}
    max_abs = {k: 0.0 for k in expected}
    for alias, args in jobs.items():
        ref = refs[alias](*args)
        kname = kernel_of.get(alias, "ewise")
        for mode, out in (("sync", sync[alias]), ("async", asyn[alias])):
            if out.shape != ref.shape or out.dtype != ref.dtype \
                    or not bool(torch.isfinite(out).all()):
                fail(f"{alias} {mode}: {tuple(out.shape)} {out.dtype} vs "
                     f"{tuple(ref.shape)} {ref.dtype} or not finite")
            max_abs[kname] = max(max_abs[kname],
                                 float((out.double() - ref.double()).abs().max()))
            label = f"{alias} {mode} {'x'.join(map(str, args[0].shape))}"
            if kname == "ewise":
                check_bits(label, out, ref)
            elif alias == "VDP":
                check_close(label, relative(out, ref), torch.float32, VDP_TOL)
            else:
                check_close(label, normwise(out, ref), torch.float32)
    # end to end, after the counted run: wall time of the whole template
    # (blocking + burst) on the same inputs, and T1 per call
    walls = []
    session.reset_t1()
    for _ in range(E2E_REPEATS):
        t0 = time.perf_counter()
        quickstart.run(jobs, overrides=PIN)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    e2e = {"wall_ms": sorted(walls)[len(walls) // 2] * 1e3,
           "wall_ms_all": [w * 1e3 for w in walls],
           "t1_us_per_call": session.t1_seconds_per_call * 1e6,
           "requests": 2 * len(jobs)}
    halo.finalize()
    return jobs, launches, max_abs, e2e


# ---------------------------------------------------------------------------
# phase 4: times at the phase-3 shapes
# ---------------------------------------------------------------------------
def phase4(dev, jobs, launches, max_abs, e2e, card_name):
    from repro_torch.core.portability import KernelReport, time_fn
    from repro_torch.kernels.ewise.ewise import ewise_hopper
    from repro_torch.kernels.ewise.ref import OP_ATEN
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.matmul.matmul import mmm_hopper
    from repro_torch.kernels.matmul.ref import mmm_aten, mmm_ref
    from repro_torch.kernels.mvm.mvm import mvm_hopper
    from repro_torch.kernels.mvm.ref import mvm_aten, mvm_ref
    from repro_torch.kernels.vdp.ref import vdp_aten, vdp_ref
    from repro_torch.kernels.vdp.vdp import vdp_hopper

    spec, (bw, f32_peak, _bf16_peak) = peaks(card_name)
    print(f"  bounds from the {spec} data sheet: {bw / 1e12} TB/s, "
          f"{f32_peak / 1e12} TFLOP/s float32 (all phase-3 inputs are float32)")

    def ms(fn, *args):
        return time_fn(fn, *args, device=dev, warmup=3,
                       iters=TIMED_RUNS).median_s * 1e3

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bw, flops / f32_peak
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    a, b = jobs["MMM"]
    m, k = a.shape
    n = b.shape[1]
    mmm_bound = bound(4 * (m * k + k * n + m * n), 2 * m * n * k)
    ea, eb = jobs["EWMM"]
    ne = ea.numel()
    ew_bound = bound(4 * 3 * ne, ne)
    ma, mx = jobs["MVM"]
    mm, mk = ma.shape
    mvm_bound = bound(4 * (mm * mk + mk + mm), 2 * mm * mk)
    vx, vy = jobs["VDP"]
    nv = vx.numel()
    vdp_bound = bound(4 * (2 * nv + 1), 2 * nv)

    per_op = {}
    for op in ("mul", "div", "add", "sub"):
        per_op[op] = {"ms": ms(ewise_hopper, ea, eb, op),
                      "plain_ms": ms(EW_REFS[op], ea, eb),
                      "library_ms": ms(OP_ATEN[op], ea, eb)}
    rows = [
        ("mmm", {"ms": ms(mmm_hopper, a, b), "plain_ms": ms(mmm_ref, a, b),
                 "library_ms": ms(mmm_aten, a, b)}, mmm_bound,
         f"{m}x{k}@{k}x{n} float32"),
        ("ewise", dict(per_op["mul"]), ew_bound, f"{ea.shape[0]}x{ea.shape[1]} "
         f"float32, EWMM (per op below)"),
        ("mvm", {"ms": ms(mvm_hopper, ma, mx), "plain_ms": ms(mvm_ref, ma, mx),
                 "library_ms": ms(mvm_aten, ma, mx)}, mvm_bound,
         f"{mm}x{mk}@{mk} float32"),
        ("vdp", {"ms": ms(vdp_hopper, vx, vy), "plain_ms": ms(vdp_ref, vx, vy),
                 "library_ms": ms(vdp_aten, vx, vy)}, vdp_bound,
         f"n={nv} float32"),
    ]
    kernels = []
    for name, times, (bound_ms, bound_by), shape in rows:
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{name}.cu",
                 "replaces": REPLACES[name], "launches": launches[name],
                 "max_abs_err": max_abs[name], **times, "bound_ms": bound_ms,
                 "bound_by": bound_by, "shape": shape}
        if name == "ewise":
            entry["per_op"] = per_op
        kernels.append(entry)
        print(f"  {name:6s} {shape:40s} kernel_ms {times['ms']:.4f}  plain_ms "
              f"{times['plain_ms']:.4f}  library_ms {times['library_ms']:.4f}  "
              f"bound_ms {bound_ms:.4f} ({bound_by})  launches {launches[name]}")
    for op, t in per_op.items():
        print(f"  ewise {op}: kernel_ms {t['ms']:.4f}  plain_ms "
              f"{t['plain_ms']:.4f}  library_ms {t['library_ms']:.4f}")
    # the paper's evaluation row per kernel: T3 of the library call as the
    # baseline, of the kernel as HALO's, of the plain version as the
    # hardware-agnostic one; T1 from the end-to-end runs; Φ = T3_base/T3_halo
    print("  " + KernelReport.csv_header())
    for entry in kernels:
        report = KernelReport(entry["name"], card_name,
                              t1_s=e2e["t1_us_per_call"] * 1e-6,
                              t3_baseline_s=entry["library_ms"] * 1e-3,
                              t3_halo_s=entry["ms"] * 1e-3,
                              t3_agnostic_s=entry["plain_ms"] * 1e-3)
        entry["phi"] = report.halo_score
        print("  " + report.csv())
    # device time the template's 14 requests need: each kernel's median
    # times the launches the counted run made (EW per op: two each)
    busy = sum(per_op[op]["ms"] * 2 for op in per_op) + sum(
        e["ms"] * e["launches"] for e in kernels if e["name"] != "ewise")
    e2e["kernel_ms_sum"] = busy
    e2e["device_busy_share"] = busy / e2e["wall_ms"]
    print(f"  end to end: quickstart wall {e2e['wall_ms']:.3f} ms (median of "
          f"{E2E_REPEATS}: {', '.join(f'{w:.3f}' for w in e2e['wall_ms_all'])}) "
          f"for {e2e['requests']} requests; kernel time {busy:.3f} ms; device "
          f"busy share {e2e['device_busy_share']:.3f}; T1 "
          f"{e2e['t1_us_per_call']:.1f} us per call")
    print(json.dumps({"e2e": e2e}))
    return kernels


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    from repro_torch.kernels import _cuda

    dev = torch.device("cuda", 0)
    print("phase 1: build")
    t0 = time.perf_counter()
    so = _cuda.build()
    print(f"  built {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in (so.parent / "build.log").read_text().splitlines():
        if "registers" in line or "bytes stack" in line or "error" in line:
            print("  ptxas:", line.strip())
    _cuda.lib()
    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    print("phase 2: kernels against their plain versions on the card")
    phase2(dev)
    print("phase 3: quickstart through claim/send/recv and isend/waitall, "
          "pinned to hopper")
    jobs, launches, max_abs, e2e = phase3(dev)
    print("phase 4: times (median of 20 CUDA-event-timed calls)")
    kernels = phase4(dev, jobs, launches, max_abs, e2e, card.split(",")[0])

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
