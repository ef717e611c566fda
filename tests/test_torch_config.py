"""The port's typed ``HALO_*`` knobs (``repro_torch.core.config``) and their
parsing (``repro_torch.core.envutil``), held against the JAX package's:
the kept fields' defaults equal ``repro.core.config.HaloConfig``'s field
for field; the environment beats a default and an override beats the
environment without touching ``os.environ``; an unknown field raises; a
snapshot is frozen; the facade exposes the names (``spawn_worker``
among them); ``env_flag``, ``env_float``, ``env_int`` and ``env_path``
parse a table of raw strings exactly as the reference's readers do.
Each knob kept has a reader in the port, named here."""
import dataclasses
import os

import pytest

from repro import halo as jhalo
from repro.core import config as j_config
from repro.core import envutil as j_env
from repro_torch import halo
from repro_torch.core import config as t_config
from repro_torch.core import envutil as t_env
from repro_torch.core.agents import HealthConfig, RuntimeAgent
from repro_torch.core.scheduler import CostModelScheduler

#: a field of the port's HaloConfig -> its env var and a value to set there
KNOBS = {
    "health_monitor": ("HALO_HEALTH_MONITOR", "1", True),
    "heartbeat_timeout": ("HALO_HEARTBEAT_TIMEOUT", "2.5", 2.5),
    "health_poll": ("HALO_HEALTH_POLL", "0.125", 0.125),
    "straggler_multiple": ("HALO_STRAGGLER_MULTIPLE", "3", 3.0),
    "straggler_min_s": ("HALO_STRAGGLER_MIN", "0.5", 0.5),
    "autotune_cache": ("HALO_AUTOTUNE_CACHE", "/nonexistent/at.json",
                       "/nonexistent/at.json"),
    "tuning_db": ("HALO_TUNING_DB", "/nonexistent/tuning.json",
                  "/nonexistent/tuning.json"),
    "wire_cache_mb": ("HALO_WIRE_CACHE_MB", "64", 64),
    "remote_timeout": ("HALO_REMOTE_TIMEOUT", "30", 30.0),
    "worker_timeout": ("HALO_WORKER_TIMEOUT", "15", 15.0),
    "worker_log": ("HALO_WORKER_LOG", "INFO", "INFO"),
}

RAW = [None, "", "0", "1", "yes", "no", "false", "2.5", "-1e-3", "inf", "nan",
       " 3 ", "banana", "1_000", "0x10", "1e309"]


@pytest.fixture(autouse=True)
def _fresh_config():
    t_config.reset_config()
    j_config.reset_config()
    yield
    t_config.reset_config()
    j_config.reset_config()


def test_kept_fields_are_the_reference_fields_with_its_defaults():
    port = {f.name: f.default for f in dataclasses.fields(t_config.HaloConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(j_config.HaloConfig)}
    assert set(port) == set(KNOBS)
    assert set(port) <= set(ref)
    assert port == {k: ref[k] for k in port}
    assert dataclasses.asdict(t_config.halo_config()) == \
        {k: dataclasses.asdict(j_config.halo_config())[k] for k in port}


@pytest.mark.parametrize("field", list(KNOBS))
def test_env_beats_default_and_override_beats_env(monkeypatch, field):
    var, raw, value = KNOBS[field]
    monkeypatch.setenv(var, raw)
    assert getattr(t_config.halo_config(), field) == value \
        == getattr(j_config.halo_config(), field)
    other = {"health_monitor": False, "autotune_cache": "/elsewhere.json",
             "tuning_db": "/elsewhere.tuning.json",
             "worker_log": "DEBUG"}.get(field, 7.0)
    snap = t_config.configure(**{field: other})
    assert getattr(snap, field) == other
    assert os.environ[var] == raw                # never written back
    t_config.configure(**{field: None})          # None clears the override
    assert getattr(t_config.halo_config(), field) == value


def test_unknown_field_raises_and_snapshot_is_frozen():
    with pytest.raises(TypeError, match="unknown HaloConfig field"):
        t_config.configure(fusion=False)          # the reference's, not kept
    with pytest.raises(TypeError):
        t_config.configure(heartbeat_timout=1.0)
    snap = t_config.halo_config()
    with pytest.raises(dataclasses.FrozenInstanceError):
        snap.heartbeat_timeout = 1.0
    t_config.configure(heartbeat_timeout=5.0)
    assert snap.heartbeat_timeout == 30.0        # a snapshot does not move
    t_config.reset_config()
    assert t_config.halo_config().heartbeat_timeout == 30.0


def test_facade_exposes_config():
    assert halo.HaloConfig is t_config.HaloConfig
    assert halo.configure is t_config.configure
    assert halo.config is t_config.halo_config
    for name in ("HaloConfig", "configure", "config"):
        assert name in halo.__all__ and name in jhalo.__all__
    assert halo.configure(straggler_min_s=0.1) == halo.config()
    assert halo.config().straggler_min_s == 0.1


def test_facade_exposes_spawn_worker():
    from repro_torch.distributed import remote
    assert halo.spawn_worker is remote.spawn_worker
    assert "spawn_worker" in halo.__all__ and "spawn_worker" in jhalo.__all__


def test_worker_knobs_have_their_readers(monkeypatch):
    """wire_cache_mb reaches the wire ledger, remote_timeout the remote
    agent, worker_timeout spawn_worker's default, worker_log the worker
    launcher.  The reference's wire_cache and wire_cache_min are constants
    here, and its worker_devices (XLA's fan-out) is not taken: no
    ``--devices`` reaches the worker."""
    from repro_torch.distributed import remote
    from repro_torch.launch import worker as t_worker
    halo.configure(wire_cache_mb=3, remote_timeout=4.5, worker_timeout=0.5,
                   worker_log="ERROR")
    cache = remote._WireCache()
    assert cache.cap_bytes == 3 << 20 and remote.WIRE_CACHE_MIN == 4096
    for field in ("wire_cache", "wire_cache_min", "worker_devices"):
        with pytest.raises(TypeError, match="unknown HaloConfig field"):
            halo.configure(**{field: 1})

    class _Handle:
        name, dead = "w9", False
    assert remote.RemoteAgent(_Handle(), "hopper")._timeout == 4.5
    seen = {}

    class _Proc:
        def __init__(self, cmd, env):
            seen["cmd"] = cmd

        def poll(self):
            return 1                      # exits at once: no hello

        def kill(self):
            pass

        def wait(self, timeout=None):
            return 1
    monkeypatch.setattr(remote.subprocess, "Popen", _Proc)
    with pytest.raises(remote.RemoteWorkerError, match="within 0.5s"):
        remote.spawn_worker("w9", device="cpu")
    assert "--devices" not in seen["cmd"]
    levels = []
    monkeypatch.setattr(t_worker.logging, "basicConfig",
                        lambda **kw: levels.append(kw["level"]))
    import repro_torch.distributed.remote as r
    monkeypatch.setattr(r, "connect_and_serve",
                        lambda *a, **kw: seen.update(serve=kw))
    assert t_worker.main(["--connect", "127.0.0.1:1", "--device", "cpu"]) == 0
    assert levels == ["ERROR"]
    assert seen["serve"] == {"name": "w0", "platforms": ["hopper", "aten", "torch"],
                             "device": "cpu"}


def test_each_knob_has_its_reader(monkeypatch, tmp_path):
    """health_* and straggler_* reach HealthConfig, health_monitor the
    session, autotune_cache the default scheduler and its TuningDB's
    sibling path, tuning_db the default scheduler's TuningDB."""
    halo.configure(heartbeat_timeout=3.0, health_poll=0.5,
                   straggler_multiple=2.0, straggler_min_s=0.01,
                   autotune_cache=str(tmp_path / "at.json"))
    assert dataclasses.asdict(HealthConfig.from_env()) == {
        "heartbeat_timeout": 3.0, "poll_interval": 0.5, "straggler_multiple": 2.0,
        "straggler_min_s": 0.01}
    assert CostModelScheduler.default().cache_path == tmp_path / "at.json"
    assert CostModelScheduler.default().tuning.path == tmp_path / "at.tuning.json"
    halo.configure(tuning_db=str(tmp_path / "db.json"))
    assert CostModelScheduler.default().tuning.path == tmp_path / "db.json"
    halo.configure(health_monitor=True)
    s = RuntimeAgent(device="cpu")
    try:
        assert s.health is not None
        assert s.health.config.heartbeat_timeout == 3.0
    finally:
        s.finalize()


@pytest.mark.parametrize("raw", RAW, ids=repr)
def test_env_readers_parse_as_the_reference_does(monkeypatch, raw):
    name = "HALO_TEST_KNOB"
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    for default in (False, True):
        assert t_env.env_flag(name, default) == j_env.env_flag(name, default)
    for default in (None, 1.5):
        got, want = t_env.env_float(name, default), j_env.env_float(name, default)
        assert (got != got and want != want) or got == want   # nan == nan here
    for default in (None, "/d"):
        assert t_env.env_path(name, default) == j_env.env_path(name, default)
    for default in (0, 4096):
        assert t_env.env_int(name, default) == j_env.env_int(name, default)
