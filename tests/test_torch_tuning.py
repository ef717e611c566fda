"""Shape-bucketed autotuning in the port (``repro_torch.core.tuning``,
``repro_torch.launch.tune``; DESIGN.md §9) on the CPU, held to the JAX
package case by case (tests/test_tuning.py): keys, buckets and dtype tags
equal to the reference's on the same numpy-built inputs; DB files written
by either package load in the other; merge-on-save, corrupt-file recovery,
``config_feasible``; the selection ladder (tuned → EMA → cost model, a
tuned entry flipping the choice, a stale entry falling through,
``tuning_db=False``); ``_tuned_kwargs`` through dispatch and
claim/send/recv with caller kwargs winning; ``HALO_TUNING_DB`` through
``MPIX_Initialize``/``halo_dispatch``; ``autotune`` under an injected
timer committing what the reference commits; the ``--smoke --device cpu``
CLI.  Then the port's own: each hopper space (MMM, EW*, RMSNORM, SORT)
feasible and stable across a bucket, ``{}`` the wrappers' own plan, a plan
outside a space refused; an empty DB building no key and calling no
``variants()``; the fused call loop passing members the plan serial
dispatch gives them (the reference's loop does not: pinned)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CostModelScheduler as JaxScheduler
from repro.core import KernelRecord as JaxRecord
from repro.core import KernelRegistry as JaxRegistry
from repro.core import RuntimeAgent as JaxAgent
from repro.core import default_manifest as jax_manifest
from repro.core import tuning as j_tuning
from repro.core.fusion import register_fusible as jax_register_fusible
from repro.core.graph import halo_graph as jax_graph
from repro.core.scheduler import abstract_signature as jax_signature
from repro_torch import halo
from repro_torch.core import (CostModelScheduler, KernelRecord,
                              KernelRegistry, RuntimeAgent, TuneEntry,
                              TuningDB, abstract_signature, autotune,
                              config_feasible, default_manifest,
                              shape_bucket, tuning_key)
from repro_torch.core import tuning as t_tuning
from repro_torch.core.fusion import register_fusible
from repro_torch.core.graph import halo_graph
from repro_torch.core.tuning import dtype_tag
from repro_torch.kernels import register_all
from repro_torch.kernels.common import cdiv, round_up
from repro_torch.kernels.ewise.ewise import ITEMS, ewise_plan, ewise_space
from repro_torch.kernels.ewise.ref import OP_REFS
from repro_torch.kernels.matmul import mmm
from repro_torch.kernels.matmul.matmul import (SKINNY_M_MAX, mmm_space,
                                               skinny_plan,
                                               skinny_splits_space)
from repro_torch.kernels.matmul.ref import mmm_ref, mmm_splitk_ref
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import (ROW_WARPS, rmsnorm_plan,
                                                 rmsnorm_space)
from repro_torch.kernels.sorthist import sort, sort_ref
from repro_torch.kernels.sorthist.sorthist import sort_space, sort_tile_plan

SPACE = [dict(bm=64), dict(bm=128)]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _spy_record(seen, alias="SPY", platform="hopper", space=None, **kw):
    """A record whose fn appends every received kwargs dict to ``seen``."""
    def fn(a, **kwargs):
        seen.append(dict(kwargs))
        return a + 1.0

    if space is None:
        def space(a, **kwargs):
            return [dict(c) for c in SPACE]
    return KernelRecord(alias=alias, fn=fn, platform=platform,
                        tuning_space=space, **kw)


def _seed(db, record, args, config, seconds=1e-6, default_seconds=1e-3):
    sig = abstract_signature(args)
    key = tuning_key(record.platform, record.alias, shape_bucket(sig),
                     dtype_tag(sig))
    db.put(key, TuneEntry(config=config, seconds=seconds,
                          default_seconds=default_seconds, source="seed"))
    return key


def _registry():
    """A fresh registry with the built-in rows (other tests may add rows
    to the global one)."""
    reg = KernelRegistry()
    register_all(reg)
    return reg


def _hopper(reg, alias):
    return next(r for r in reg.records(alias) if r.platform == "hopper")


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# keys + buckets, against the reference
# ---------------------------------------------------------------------------
SIGS = [  # (shapes, dtypes) of positional args; None is the scalar 7
    ([(300, 5), (128,), None], [torch.float32, torch.bfloat16, None]),
    ([(4, 2560), (2560, 640)], [torch.bfloat16, torch.bfloat16]),
    ([(512, 6912), (6912, 2560)], [torch.float16, torch.float16]),
    ([(8192, 8192), (8192, 8192)], [torch.float32, torch.float32]),
    ([(4096, 2560), (2560,)], [torch.bfloat16, torch.bfloat16]),
    ([(1,), (0, 3)], [torch.float32, torch.float32]),
]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}


@pytest.mark.parametrize("case", range(len(SIGS)))
def test_shape_bucket_dtype_tag_and_key_equal_the_reference(case):
    shapes, dtypes = SIGS[case]
    t_args, j_args = [], []
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        if shape is None:
            t_args.append(7)
            j_args.append(7)
            continue
        x = _np(i, shape)
        t_args.append(torch.from_numpy(x).to(dt))
        j_args.append(jnp.asarray(x).astype(JNP[dt]))
    t_sig, j_sig = abstract_signature(t_args), jax_signature(j_args)
    assert shape_bucket(t_sig) == j_tuning.shape_bucket(j_sig)
    assert dtype_tag(t_sig) == j_tuning.dtype_tag(j_sig)
    assert "torch." not in dtype_tag(t_sig)
    for platform, alias in (("hopper", "MMM"), ("pallas", "RMSNORM")):
        assert tuning_key(platform, alias, shape_bucket(t_sig), dtype_tag(t_sig)) \
            == j_tuning.tuning_key(platform, alias, j_tuning.shape_bucket(j_sig),
                                   j_tuning.dtype_tag(j_sig))
    if case == 0:                              # the reference test's own case
        assert shape_bucket(t_sig) == "512x8,128,-"
        assert dtype_tag(t_sig) == "float32+bfloat16+int"


# ---------------------------------------------------------------------------
# TuningDB persistence
# ---------------------------------------------------------------------------
def test_tuningdb_roundtrip(tmp_path):
    path = tmp_path / "tuning.json"
    db = TuningDB(path)
    ent = TuneEntry(config={"tile_n": 128}, seconds=2e-4, default_seconds=4e-4)
    db.put("hopper|MMM|512x4096,4096x1024|bfloat16", ent)
    assert db.save() == path
    warm = TuningDB(path)
    got = warm.get("hopper|MMM|512x4096,4096x1024|bfloat16")
    assert got is not None and got.config == {"tile_n": 128}
    assert got.seconds == pytest.approx(2e-4)
    assert got.frozen and got.speedup == pytest.approx(2.0)
    assert json.loads(path.read_text())["version"] == 1


def test_db_files_cross_load_between_the_packages(tmp_path):
    """A file the port writes loads in repro.core.tuning.TuningDB with the
    same entries, and the reverse."""
    rows = {"hopper|MMM|4x4096,4096x1024|bfloat16":
            dict(config={"route": "wgmma", "tile_n": 128}, seconds=3e-5,
                 default_seconds=4e-5, repeats=3, frozen=True, source="sweep"),
            "hopper|RMSNORM|512x4096,4096|bfloat16":
            dict(config={}, seconds=1e-5, default_seconds=1e-5, repeats=5,
                 frozen=False, source="seed")}
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    t_db, j_db = TuningDB(port_path), j_tuning.TuningDB(ref_path)
    for key, row in rows.items():
        t_db.put(key, TuneEntry(**row))
        j_db.put(key, j_tuning.TuneEntry(**row))
    t_db.save()
    j_db.save()
    assert json.loads(port_path.read_text()) == json.loads(ref_path.read_text())
    from_port = j_tuning.TuningDB(port_path).entries()
    from_ref = TuningDB(ref_path).entries()
    assert {k: e.to_json() for k, e in from_port.items()} == rows
    assert {k: e.to_json() for k, e in from_ref.items()} == rows


def test_tuningdb_merge_on_save(tmp_path):
    """Two writers share one file: a plain overwrite must not clobber the
    other's winners, and conflicts resolve to the faster entry."""
    path = tmp_path / "tuning.json"
    a, b = TuningDB(path), TuningDB(path)
    a.put("k1", TuneEntry(config={"bm": 64}, seconds=5e-4,
                          default_seconds=6e-4))
    a.save()
    b.put("k2", TuneEntry(config={"bn": 128}, seconds=1e-4,
                          default_seconds=2e-4))
    b.put("k1", TuneEntry(config={"bm": 256}, seconds=1e-4,
                          default_seconds=6e-4))
    b.save()
    merged = TuningDB(path)
    assert set(merged.entries()) == {"k1", "k2"}
    assert merged.get("k1").config == {"bm": 256}
    a.save()
    assert TuningDB(path).get("k1").config == {"bm": 256}
    # frozen beats unfrozen whatever the times
    c = TuningDB(path)
    c.put("k1", TuneEntry(config={"bm": 8}, seconds=1e-9, default_seconds=1e-3,
                          frozen=False))
    c.save()
    assert TuningDB(path).get("k1").config == {"bm": 256}


def test_tuningdb_corrupt_file_recovery(tmp_path):
    path = tmp_path / "tuning.json"
    path.write_text("{not json at all")
    db = TuningDB(path)                        # must not raise
    assert len(db) == 0
    db.put("k", TuneEntry(config={}, seconds=1e-4, default_seconds=1e-4))
    assert db.save() == path
    assert TuningDB(path).get("k") is not None
    path.write_text(json.dumps({"entries": {
        "good": {"config": {}, "seconds": 1e-4, "default_seconds": 1e-4},
        "bad": {"seconds": "nope"}}}))
    db2 = TuningDB(path)
    assert set(db2.entries()) == {"good"}
    path.write_text(json.dumps([1, 2, 3]))
    assert len(TuningDB(path)) == 0
    for text in ("{not json", json.dumps([1, 2, 3])):   # and as the reference
        path.write_text(text)
        assert len(j_tuning.TuningDB(path)) == len(TuningDB(path)) == 0


# ---------------------------------------------------------------------------
# feasibility guards
# ---------------------------------------------------------------------------
def test_config_feasible_against_variants():
    rec = _spy_record([])
    args = (torch.zeros((8, 8)),)
    assert config_feasible(rec, {"bm": 64}, args)
    assert config_feasible(rec, {}, args)
    assert not config_feasible(rec, {"bm": 4096}, args)
    assert not config_feasible(rec, {"bogus": 1}, args)


def test_raising_space_is_empty_and_register_fn_takes_a_space():
    def bad_space(*args, **kw):
        raise ValueError("boom")
    broken = KernelRecord(alias="X", fn=lambda a: a, platform="torch",
                          tuning_space=bad_space)
    assert broken.variants(torch.zeros(3)) == []
    assert KernelRecord(alias="X", fn=lambda a: a, platform="torch").variants(1) == []
    reg = KernelRegistry()

    @reg.register_fn("Y", "hopper", tuning_space=lambda a: [{"k": 1}])
    def y(a, k=0):
        return a

    rec, = reg.records("Y")
    assert rec.variants(torch.zeros(2)) == [{"k": 1}]


def test_hopper_rows_declare_spaces_and_no_other_row_does():
    reg = _registry()
    tuned = {"MMM": mmm_space, "EWMM": ewise_space, "EWMD": ewise_space,
             "EWADD": ewise_space, "EWSUB": ewise_space,
             "RMSNORM": rmsnorm_space, "SORT": sort_space}
    for alias in reg.aliases():
        for rec in reg.records(alias):
            if rec.platform == "hopper" and alias in tuned:
                assert rec.tuning_space is tuned[alias], alias
            else:
                assert rec.tuning_space is None, (alias, rec.platform)


# ---------------------------------------------------------------------------
# the hopper spaces: feasible, stable across a bucket, {} the wrappers' plan
# ---------------------------------------------------------------------------
def _t(seed, shape, dtype=torch.float32, shift=0.0):
    return torch.from_numpy(_np(seed, shape) + shift).to(dtype)


# (alias, args builder at the swept shape, at another member of its bucket)
BUCKETS = {
    "mmm_bf16_decode": ("MMM", lambda s: (_t(s, (4, 2560), torch.bfloat16),
                                          _t(s + 1, (2560, 640), torch.bfloat16)),
                        lambda s: (_t(s, (3, 2100), torch.bfloat16),
                                   _t(s + 1, (2100, 1000), torch.bfloat16))),
    "mmm_bf16_prefill": ("MMM", lambda s: (_t(s, (96, 80), torch.bfloat16),
                                           _t(s + 1, (80, 72), torch.bfloat16)),
                         lambda s: (_t(s, (128, 65), torch.bfloat16),
                                    _t(s + 1, (65, 127), torch.bfloat16))),
    "mmm_f32_skinny": ("MMM", lambda s: (_t(s, (4, 2560)), _t(s + 1, (2560, 640))),
                       lambda s: (_t(s, (3, 4096)), _t(s + 1, (4096, 513)))),
    "ewise": ("EWMD", lambda s: (_t(s, (64, 160)), _t(s + 1, (64, 160), shift=3.0)),
              lambda s: (_t(s, (40, 250)), _t(s + 1, (40, 250), shift=3.0))),
    "rmsnorm": ("RMSNORM", lambda s: (_t(s, (48, 256), torch.bfloat16),
                                      _t(s + 1, (256,), torch.bfloat16, 1.0)),
                lambda s: (_t(s, (33, 136), torch.bfloat16),
                           _t(s + 1, (136,), torch.bfloat16, 1.0))),
    "sort": ("SORT", lambda s: (_t(s, (8, 100)),), lambda s: (_t(s, (5, 65)),)),
}
PLAIN = {"MMM": mmm_ref, "EWMD": OP_REFS["div"], "RMSNORM": rmsnorm_ref,
         "SORT": sort_ref}


@pytest.mark.parametrize("name", sorted(BUCKETS))
def test_space_feasible_and_stable_across_a_bucket(name):
    """Every member of a shape bucket gets the same variant list, so a
    winner swept at one member is a feasible config for all of them; every
    variant runs through the hopper row (on the CPU: checked, then the
    plain version) and equals the default call."""
    alias, swept_of, member_of = BUCKETS[name]
    rec = _hopper(_registry(), alias)
    swept, member = swept_of(0), member_of(2)
    sig_a, sig_b = abstract_signature(swept), abstract_signature(member)
    assert shape_bucket(sig_a) == shape_bucket(sig_b)
    variants = rec.variants(*swept)
    assert variants and variants == rec.variants(*member)
    assert {} not in variants and len({repr(v) for v in variants}) == len(variants)
    for args in (swept, member):
        ref = PLAIN[alias](*args)
        assert torch.equal(rec.fn(*args), ref)
        for cfg in variants:
            assert config_feasible(rec, cfg, args)
            assert torch.equal(rec.fn(*args, **cfg), ref), cfg


def test_mmm_space_by_type_and_rows():
    """16-bit: skinny splits + both wgmma widths at M ≤ SKINNY_M_MAX, both
    widths above; float32: skinny splits + tf32x3, then nothing."""
    def space(m, k, n, dt):
        return mmm_space(torch.empty(m, k, dtype=dt), torch.empty(k, n, dtype=dt))
    for dt in (torch.bfloat16, torch.float16):
        small = space(SKINNY_M_MAX, 2560, 640, dt)
        splits = skinny_splits_space(SKINNY_M_MAX, 640, 2560, 2)
        assert small == [{"route": "skinny", "splits": s} for s in splits] + [
            {"route": "wgmma", "tile_n": 128}, {"route": "wgmma", "tile_n": 256}]
        assert space(SKINNY_M_MAX + 1, 2560, 640, dt) == [{"tile_n": 128},
                                                          {"tile_n": 256}]
    small = space(4, 2560, 640, torch.float32)
    assert small[-1] == {"route": "tf32x3"}
    assert all(v["route"] == "skinny" for v in small[:-1])
    assert space(65, 2560, 640, torch.float32) == []
    assert space(4, 0, 640, torch.bfloat16) == []
    assert mmm_space(torch.empty(4, 8), torch.empty(9, 8)) == []
    # every split count lies within K's 32-row segments at the bucket's least K
    for k in (80, 2049, 2560, 4096, 6912):
        for s in skinny_splits_space(4, 640, k, 2):
            assert 1 <= s <= max(1, ((1 << (k - 1).bit_length()) // 2 + 1) // 32)


def test_default_plan_is_the_wrappers_rule_bit_for_bit():
    """``{}`` is today's plan: skinny_plan, ewise_plan, rmsnorm_plan and
    sort_tile_plan with no override equal the rules, and a given override
    replaces only the tuned quantity."""
    for m, n, k in ((4, 640, 2560), (4, 2560, 6912), (64, 32000, 2560), (1, 8, 5)):
        assert skinny_plan(m, n, k, 2, None) == skinny_plan(m, n, k, 2)
        s, kb, kw = skinny_plan(m, n, k, 2, 7)
        assert kb == max(8, round_up(cdiv(k, 7), 8)) and s * kb >= k > (s - 1) * kb
    for n, u in ((8192 * 8192, 1), (100, 4)):
        plan = ewise_plan(n, torch.float32, True, 132, u)
        assert plan.items_per_thread == u
        assert plan.blocks == max(1, cdiv(n // 4, u * 256))
    assert ewise_plan(1 << 26, torch.float32, True, 132, None) == \
        ewise_plan(1 << 26, torch.float32, True, 132)
    for rows in (4, 512, 4096):
        assert rmsnorm_plan(rows, 2560, 2, 132, True, None) == \
            rmsnorm_plan(rows, 2560, 2, 132, True)
        for w in ROW_WARPS:
            assert rmsnorm_plan(rows, 2560, 2, 132, True, w)[:2] == (w, cdiv(320, 32 * w))
        # rows off the 16-byte grid stay on the block kernel
        assert rmsnorm_plan(rows, 2560, 2, 132, False, 2).warps_per_row == 0
    assert sort_tile_plan(4096, 4096, 132, None) == sort_tile_plan(4096, 4096, 132)
    assert sort_tile_plan(40, 100, 132, 16).rows_per_block == 16
    assert sort_tile_plan(40, 100, 132, 16).blocks == 3


def test_plan_outside_the_space_raises_on_the_cpu():
    a, b = _t(0, (4, 64), torch.bfloat16), _t(1, (64, 32), torch.bfloat16)
    assert torch.equal(mmm(a, b, route="wgmma", tile_n=256), mmm_ref(a, b))
    for bad in (dict(tile_n=128), dict(route="tf32x3"), dict(splits=3),
                dict(route="wgmma", tile_n=64), dict(route="skinny", splits=999)):
        with pytest.raises(ValueError, match="tuning space"):
            mmm(a, b, **bad)
    x, g = _t(2, (3, 80), torch.bfloat16), _t(3, (80,), torch.bfloat16)
    with pytest.raises(ValueError, match="tuning space"):
        rmsnorm(x, g, warps_per_row=3)
    with pytest.raises(ValueError, match="tuning space"):   # rows off 16 bytes
        rmsnorm(_t(2, (3, 81), torch.bfloat16), _t(3, (81,), torch.bfloat16),
                warps_per_row=1)
    with pytest.raises(ValueError, match="tuning space"):
        sort(_t(4, (2, 9000)), rows_per_block=1)            # the radix route
    with pytest.raises(ValueError, match="tuning space"):
        sort(_t(4, (2, 100)), rows_per_block=2)
    from repro_torch.kernels.ewise import ewadd
    with pytest.raises(ValueError, match="tuning space"):
        ewadd(_t(5, (4,)), _t(6, (4,)), items_per_thread=2)
    assert ewise_space(_t(5, (4,)), _t(6, (4,))) == [
        {"items_per_thread": u} for u in ITEMS]
    assert ewise_space(torch.empty(0), torch.empty(0)) == []


def test_splitk_model_takes_the_tuned_split_count():
    """mmm_splitk_ref(splits=s) sums K in the segments of the tuned plan:
    against float64 within float32's sum-order error at every split
    count of the space, and equal to the default model at the default
    count."""
    a, b = _t(0, (4, 2560)), _t(1, (2560, 640))
    exact = (a.double() @ b.double()).float()
    for s in skinny_splits_space(4, 640, 2560, 4):
        got = mmm_splitk_ref(a, b, splits=s)
        assert float((got - exact).norm() / exact.norm()) < 1e-6
    default = skinny_plan(4, 640, 2560, 4)[0]
    assert torch.equal(mmm_splitk_ref(a, b, splits=default), mmm_splitk_ref(a, b))


# ---------------------------------------------------------------------------
# selection precedence (DESIGN.md §9 ladder)
# ---------------------------------------------------------------------------
def test_tuned_entry_beats_ema_and_cost_model():
    seen = []
    rec = _spy_record(seen, cost_model=lambda a: 9e-3)
    sched = CostModelScheduler()
    args = (torch.zeros((64, 64)),)
    sig = abstract_signature(args)
    assert sched.estimate(rec, sig, args) == pytest.approx(9e-3)   # cost model
    for _ in range(3):
        sched.observe(rec, sig, 5e-3)
    assert sched.estimate(rec, sig, args) == pytest.approx(5e-3)   # EMA
    _seed(sched.tuning, rec, args, {"bm": 64}, seconds=1e-6)
    assert sched.estimate(rec, sig, args) == pytest.approx(1e-6)   # tuned
    assert sched.tuned_config(rec, args) == {"bm": 64}


def test_tuned_entry_flips_record_choice():
    """A tuned entry on the statically-dispreferred record outranks the
    preferred record's EMA — rung 1 beats rung 2 across records too."""
    reg = KernelRegistry()
    seen = []
    slow = KernelRecord(alias="K", fn=lambda a: a + 5.0, platform="aten",
                        priority=10)
    fast = _spy_record(seen, alias="K", platform="torch", priority=0,
                       is_failsafe=True)
    reg.register(slow)
    reg.register(fast)
    sched = CostModelScheduler()
    args = (torch.zeros(4),)
    sig = abstract_signature(args)
    for _ in range(3):
        sched.observe(slow, sig, 1e-4)
    _seed(sched.tuning, fast, args, {"bm": 64}, seconds=1e-6)
    agent = RuntimeAgent(registry=reg, manifest=default_manifest(),
                         scheduler=sched, device="cpu")
    try:
        cr = agent.claim("K")
        agent.send(args, cr)
        assert torch.equal(agent.recv(cr), torch.ones(4))      # torch won
        assert seen and seen[-1] == {"bm": 64}                 # at the tuned plan
    finally:
        agent.finalize()


def test_stale_infeasible_entry_falls_through():
    seen = []
    rec = _spy_record(seen, is_failsafe=True)
    sched = CostModelScheduler()
    args = (torch.zeros((64, 64)),)
    sig = abstract_signature(args)
    for _ in range(3):
        sched.observe(rec, sig, 7e-3)
    _seed(sched.tuning, rec, args, {"bm": 9999}, seconds=1e-6)  # infeasible
    assert sched.estimate(rec, sig, args) == pytest.approx(7e-3)
    assert sched.tuned_config(rec, args) is None
    reg = KernelRegistry()
    reg.register(rec)
    agent = RuntimeAgent(registry=reg, manifest=default_manifest(),
                         scheduler=sched, device="cpu")
    try:
        agent.dispatch("SPY", *args)
        assert seen[-1] == {}                  # no stale kwargs injected
    finally:
        agent.finalize()


def test_stale_entry_within_one_bucket_of_real_kernels():
    """Buckets are powers of two: a stored plan the space does not offer
    (a split count off the bucket's list) falls through to the default;
    one it offers holds at every shape of the bucket (4×2560 @ 2560×640
    and @ 2560×1000)."""
    rec = _hopper(_registry(), "MMM")
    a, b = _t(0, (4, 2560), torch.bfloat16), _t(1, (2560, 640), torch.bfloat16)
    db = TuningDB()
    _seed(db, rec, (a, b), {"route": "skinny", "splits": 3})      # not offered
    assert db.tuned_config_for(rec, abstract_signature((a, b)), (a, b)) is None
    good = {"route": "wgmma", "tile_n": 128}
    _seed(db, rec, (a, b), good)
    b2 = _t(2, (2560, 1000), torch.bfloat16)
    for args in ((a, b), (a, b2)):
        assert db.tuned_config_for(rec, abstract_signature(args), args) == good


def test_scheduler_without_tuning_db():
    seen = []
    rec = _spy_record(seen)
    sched = CostModelScheduler(tuning_db=False)
    assert sched.tuning is None
    args = (torch.zeros((16, 16)),)
    assert sched.tuned_config(rec, args) is None
    assert sched.estimate(rec, abstract_signature(args), args) is None


def test_default_scheduler_reads_the_db_paths(tmp_path):
    halo.configure(autotune_cache=str(tmp_path / "at.json"))
    try:
        assert CostModelScheduler.default().tuning.path == tmp_path / "at.tuning.json"
        halo.configure(tuning_db=str(tmp_path / "db.json"))
        assert CostModelScheduler.default().tuning.path == tmp_path / "db.json"
    finally:
        halo.configure(autotune_cache=None, tuning_db=None)
    assert CostModelScheduler.default().tuning.path is None


# ---------------------------------------------------------------------------
# the runtime's merge
# ---------------------------------------------------------------------------
def test_dispatch_applies_tuned_config_via_spy():
    seen = []
    reg = KernelRegistry()
    rec = _spy_record(seen, is_failsafe=True)
    reg.register(rec)
    args = (torch.zeros((32, 32)),)
    db = TuningDB()
    _seed(db, rec, args, {"bm": 128})
    session = RuntimeAgent(registry=reg, manifest=default_manifest(),
                           scheduler=CostModelScheduler(tuning_db=db),
                           device="cpu")
    try:
        out = session.dispatch("SPY", *args)
        assert torch.equal(out, torch.ones(32, 32))
        assert seen[-1] == {"bm": 128}
        cr = session.claim("SPY")
        session.send(args, cr)
        session.recv(cr)
        assert seen[-1] == {"bm": 128}
        session.dispatch("SPY", *args, bm=8)     # explicit kwargs win
        assert seen[-1] == {"bm": 8}
        session.send(args, cr, bm=64)
        session.recv(cr)
        assert seen[-1] == {"bm": 64}
        session.dispatch("SPY", torch.zeros((64, 64)))   # another bucket
        assert seen[-1] == {}
    finally:
        session.finalize()


def test_halo_dispatch_env_seeded_db(tmp_path, monkeypatch):
    from repro_torch.core import MPIX_Finalize, MPIX_Initialize, halo_dispatch

    seen = []
    reg = KernelRegistry()
    rec = _spy_record(seen, is_failsafe=True)
    reg.register(rec)
    args = (torch.zeros((32, 32)),)
    path = tmp_path / "db.json"
    db = TuningDB(path)
    _seed(db, rec, args, {"bm": 64})
    db.save()
    monkeypatch.setenv("HALO_TUNING_DB", str(path))
    try:
        MPIX_Initialize(registry=reg, device="cpu")
        halo_dispatch("SPY", *args)
        assert seen[-1] == {"bm": 64}
    finally:
        MPIX_Finalize()


def test_empty_db_builds_no_key_and_calls_no_variants(monkeypatch):
    """The merge runs on every dispatch: with no entries it returns before
    a key is built or a space consulted; with entries each (record,
    signature) consults the space once until the DB changes."""
    calls = []

    def space(a, **kw):
        calls.append(tuple(a.shape))
        return [dict(bm=64)]

    seen = []
    reg = KernelRegistry()
    rec = _spy_record(seen, space=space, is_failsafe=True)
    reg.register(rec)
    db = TuningDB()
    session = RuntimeAgent(registry=reg, manifest=default_manifest(),
                           scheduler=CostModelScheduler(tuning_db=db),
                           device="cpu")
    real_key_for = TuningDB.key_for

    def no_keys(*a, **kw):
        raise AssertionError("a key was built for an empty DB")

    monkeypatch.setattr(TuningDB, "key_for", no_keys)
    monkeypatch.setattr(t_tuning, "shape_bucket", no_keys)
    try:
        args = (torch.zeros((8, 8)),)
        for _ in range(5):
            session.dispatch("SPY", *args)
            cr = session.claim("SPY")
            session.send(args, cr)
            session.recv(cr)
        assert calls == [] and seen == [{}] * 10
        monkeypatch.setattr(TuningDB, "key_for", real_key_for)
        monkeypatch.setattr(t_tuning, "shape_bucket", j_tuning.shape_bucket)
        _seed(db, rec, args, {"bm": 64})
        for _ in range(5):
            session.dispatch("SPY", *args)
        assert seen[-1] == {"bm": 64} and calls == [(8, 8)]   # memoized
        _seed(db, rec, (torch.zeros(3),), {})                 # the DB changes
        session.dispatch("SPY", *args)
        assert calls == [(8, 8), (8, 8)]
    finally:
        session.finalize()


def test_real_mmm_dispatch_under_a_db_on_the_cpu():
    """The hopper MMM row under a seeded entry: dispatch carries the plan
    to the wrapper, which checks it and runs the plain version; a stale
    plan falls through; the torch and aten rows are never given one."""
    reg = _registry()
    rec = _hopper(reg, "MMM")
    a, b = _t(0, (4, 96), torch.bfloat16), _t(1, (96, 40), torch.bfloat16)
    db = TuningDB()
    _seed(db, rec, (a, b), {"route": "wgmma", "tile_n": 128})
    sess = RuntimeAgent(registry=reg, manifest=default_manifest(),
                        scheduler=CostModelScheduler(tuning_db=db), device="cpu")
    seen = []
    real = rec.fn
    rec.fn = lambda *args, **kw: (seen.append(kw), real(*args, **kw))[1]
    try:
        for pin in ("hopper", "aten", "torch"):
            cr = sess.claim("MMM", overrides={"allowed_platforms": [pin]})
            sess.send((a, b), cr)
            assert torch.equal(sess.recv(cr), mmm_ref(a, b))
        assert seen == [{"route": "wgmma", "tile_n": 128}]
    finally:
        sess.finalize()


# ---------------------------------------------------------------------------
# sweep driver, against the reference
# ---------------------------------------------------------------------------
def _twins(fn_t, fn_j, space):
    """(port record, reference record) over the same fn and space."""
    return (KernelRecord(alias="K", fn=fn_t, platform="torch", tuning_space=space),
            JaxRecord(alias="K", fn=fn_j, platform="jnp", tuning_space=space))


def _same_result(res, jres):
    assert res.key.split("|")[1:3] == jres.key.split("|")[1:3]
    assert res.swept == jres.swept
    assert res.entry.to_json() == jres.entry.to_json()
    assert res.timings == jres.timings


def test_autotune_sweep_commits_and_freezes_as_the_reference():
    calls = {"t": [], "j": []}

    def fn(tag):
        def f(a, bm=None):
            calls[tag].append(bm)
            return a
        return f

    def ticker():
        ticks = iter(range(1000))
        return lambda: next(ticks) * 1e-3

    rec, jrec = _twins(fn("t"), fn("j"), lambda a, **kw: [dict(bm=64)])
    db, jdb = TuningDB(), j_tuning.TuningDB()
    timer, jtimer = ticker(), ticker()
    res = autotune(rec, (torch.zeros((8, 8)),), db=db, repeats=2, warmup=1,
                   timer=timer)
    jres = j_tuning.autotune(jrec, (jnp.zeros((8, 8)),), db=jdb, repeats=2,
                             warmup=1, timer=jtimer)
    _same_result(res, jres)
    assert res.swept and res.entry.frozen
    assert [cfg for cfg, _ in res.timings] == [{}, {"bm": 64}]
    assert db.get(res.key) is res.entry
    assert calls["t"] == calls["j"]
    n = len(calls["t"])
    res2 = autotune(rec, (torch.zeros((8, 8)),), db=db, repeats=2, timer=timer)
    assert not res2.swept and len(calls["t"]) == n
    res3 = autotune(rec, (torch.zeros((8, 8)),), db=db, repeats=2, force=True,
                    timer=timer)
    jres3 = j_tuning.autotune(jrec, (jnp.zeros((8, 8)),), db=jdb, repeats=2,
                              force=True, timer=jtimer)
    assert res3.swept and len(calls["t"]) > n
    assert [c for c, _ in res3.timings] == [c for c, _ in jres3.timings]


@pytest.mark.parametrize("win", [0.995, 0.5], ids=["noise", "real"])
def test_autotune_noise_keeps_the_default_as_the_reference(win):
    """A variant inside the min_gain band keeps the default; a real win is
    committed — the same entry as the reference's for the same times."""
    def make(clock):
        times = {None: 1.000, 64: win}

        def fn(a, bm=None):
            clock[0] += times[bm]
            return a
        return fn

    ct, cj = [0.0], [0.0]
    rec, jrec = _twins(make(ct), make(cj), lambda a, **kw: [dict(bm=64)])
    res = autotune(rec, (torch.zeros(4),), repeats=2, warmup=1,
                   timer=lambda: ct[0])
    jres = j_tuning.autotune(jrec, (jnp.zeros(4),), repeats=2, warmup=1,
                             timer=lambda: cj[0])
    _same_result(res, jres)
    assert res.entry.config == ({} if win > 0.99 else {"bm": 64})
    if win < 0.99:
        assert res.entry.speedup == pytest.approx(2.0)


def test_autotune_skips_a_raising_variant_as_the_reference():
    def fn(a, bm=None):
        if bm == 64:
            raise RuntimeError("infeasible after all")
        return a

    rec, jrec = _twins(fn, fn, lambda a, **kw: [dict(bm=64), dict(bm=128)])
    res = autotune(rec, (torch.zeros(4),), repeats=1)
    jres = j_tuning.autotune(jrec, (jnp.zeros(4),), repeats=1)
    assert [c for c, _ in res.timings] == [c for c, _ in jres.timings] == \
        [{}, {"bm": 128}]
    with pytest.raises(RuntimeError, match="no variant"):
        autotune(KernelRecord(alias="K", fn=lambda a, bm=None: 1 / 0,
                              platform="torch", tuning_space=lambda a: []),
                 (torch.zeros(4),))


def test_cpu_sweep_smoke_cli(tmp_path, capsys):
    """End-to-end CLI smoke on the CPU: a tiny sweep of every tunable alias,
    the DB written, the report printed, a re-run frozen."""
    from repro_torch.launch import tune

    path = tmp_path / "db.json"
    assert tune.main(["--smoke", "--device", "cpu", "--db", str(path),
                      "--report"]) == 0
    db = TuningDB(path)
    keys = sorted(db.entries())
    assert len(keys) == sum(len(v) for v in tune.SMOKE_SHAPES.values())
    assert all(e.frozen for e in db.entries().values())
    assert all(k.startswith("hopper|") for k in keys)
    out = capsys.readouterr().out
    assert "hopper|MMM|" in out and "gain_x" in out and "torch." not in out
    assert tune.main(["--smoke", "--device", "cpu", "--db", str(path)]) == 0
    assert "frozen (skipped)" in capsys.readouterr().out
    assert tune.main(["--db", str(path), "--no-sweep"]) == 0
    assert "hopper|SORT|" in capsys.readouterr().out


def test_sweep_times_every_variant_of_every_bucket():
    """sweep() over SMOKE_SHAPES on the CPU: one result a bucket, each
    timing the default and every variant of its space."""
    from repro_torch.launch import tune

    register_all()
    aliases = sorted(tune.SMOKE_SHAPES)
    results = tune.sweep(TuningDB(), aliases, repeats=1, smoke=True,
                         verbose=False, device="cpu", seed=5)
    built = [build(torch.device("cpu"), 5 + 2 * i) for alias in aliases
             for i, build in enumerate(tune.SMOKE_SHAPES[alias])]
    assert len(results) == len(built)
    for res, args in zip(results, built):
        assert res.swept and res.record.platform == "hopper"
        assert res.key == TuningDB().key_for(res.record, abstract_signature(args))
        assert [c for c, _ in res.timings] == [{}] + res.record.variants(*args)


# ---------------------------------------------------------------------------
# the fused call loop under a DB (ROADMAP §C)
# ---------------------------------------------------------------------------
def _fusible_spies(seen, platforms):
    """A fusible alias TSPY: a tunable spy record on each of ``platforms``
    and a torch fail-safe (the shape oracle)."""
    reg = KernelRegistry()
    register_fusible("TSPY")
    for p in platforms:
        reg.register(_spy_record(seen, alias="TSPY", platform=p, priority=20))
    reg.register(KernelRecord(alias="TSPY", fn=lambda a, **kw: a + 1.0,
                              platform="torch", is_failsafe=True))
    return reg


def test_fused_loop_passes_members_their_tuned_plan():
    """Serial dispatch of each member takes the DB's plan through
    _execute_on; the compiled chain's call loop passes the same plan to
    each member, resolved when the chain is compiled, so replay equals
    serial dispatch under one DB (and the plan moves with the DB)."""
    seen = []
    reg = _fusible_spies(seen, ["hopper"])
    hop = next(r for r in reg.records("TSPY") if r.platform == "hopper")
    x = torch.zeros((16, 16))
    db = TuningDB()
    _seed(db, hop, (x,), {"bm": 128})
    sess = RuntimeAgent(registry=reg, manifest=default_manifest(),
                        scheduler=CostModelScheduler(tuning_db=db), device="cpu")
    pin = {"allowed_platforms": ["hopper"], "platform_preference": ["hopper"]}
    try:
        crs = [sess.claim("TSPY", overrides=pin) for _ in range(3)]
        acc = x
        for cr in crs:
            acc = sess.isend((acc,), cr, mailbox=False).result(60)
        assert seen == [{"bm": 128}] * 3
        serial = acc
        with halo_graph(session=sess, launch=False) as g:
            acc = x
            for cr in crs:
                acc = sess.isend((acc,), cr)
        cg = g.compile()
        assert cg.stats["fused_nodes"] == 1
        seen.clear()
        out = cg.replay(timeout=60)[-1]
        assert seen == [{"bm": 128}] * 3
        assert torch.equal(out, serial)
        # another DB generation compiles apart with its own plans
        _seed(db, hop, (x,), {"bm": 64})
        with halo_graph(session=sess, launch=False) as g2:
            acc = x
            for cr in crs:
                acc = sess.isend((acc,), cr)
        cg2 = g2.compile()
        assert cg2 is not cg
        seen.clear()
        cg2.replay(timeout=60)
        assert seen == [{"bm": 64}] * 3
        assert cg.stats["fused_aliases"] != cg2.stats["fused_aliases"]
    finally:
        sess.finalize()


def test_reference_fused_loop_calls_members_at_their_default_plan():
    """Reference fault (closed in the port, ROADMAP §C): the JAX package's
    compiled call loop (repro/core/fusion.py make_composed over
    _prepared_impl) calls each member with its captured kwargs only, so a
    DB plan that serial dispatch applies never reaches a fused member."""
    seen = []
    reg = JaxRegistry()
    jax_register_fusible("TSPY")

    def fn(a, **kw):
        seen.append(dict(kw))
        return a + 1.0

    xla = reg.register(JaxRecord(alias="TSPY", fn=fn, platform="xla",
                                 priority=10, tuning_space=lambda a, **kw: SPACE))
    reg.register(JaxRecord(alias="TSPY", fn=lambda a, **kw: a + 1.0,
                           platform="jnp", is_failsafe=True))
    x = jnp.zeros((16, 16), jnp.float32)
    db = j_tuning.TuningDB()
    sig = jax_signature((x,))
    db.put(j_tuning.tuning_key("xla", "TSPY", j_tuning.shape_bucket(sig),
                               j_tuning.dtype_tag(sig)),
           j_tuning.TuneEntry(config={"bm": 128}, seconds=1e-6,
                              default_seconds=1e-3))
    sess = JaxAgent(registry=reg, manifest=jax_manifest(),
                    scheduler=JaxScheduler(tuning_db=db))
    pin = {"allowed_platforms": ["xla"], "platform_preference": ["xla"]}
    try:
        crs = [sess.claim("TSPY", overrides=pin) for _ in range(3)]
        acc = x
        for cr in crs:
            acc = sess.isend((acc,), cr, mailbox=False).result(60)
        assert seen == [{"bm": 128}] * 3          # serial: the tuned plan
        with jax_graph(session=sess, launch=False) as g:
            acc = x
            for cr in crs:
                acc = sess.isend((acc,), cr)
        cg = g.compile()
        assert cg.stats["fused_nodes"] == 1
        seen.clear()
        cg.replay(timeout=60)
        assert seen == [{}] * 3                   # fused: the default plan
        assert xla.tuning_space is not None
    finally:
        sess.finalize()
