"""Unified configuration file (C2MPI §IV-C, Table I) — port of
``repro.core.manifest``.

Three sections, as in the paper's example config:

* ``host_list``     — hosts and slot counts (here: one local H100),
* ``func_list``     — CR definitions: func_alias → sw_fid + selection strategy,
* ``platform_list`` — system configuration: hardware recommendation strategy
                      and platform preference order.

The manifest is pure data (JSON-compatible dicts); the runtime agent consumes
it to seed CR aliases and the selection strategy.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

#: the aliases this package registers (kernels.register_all)
SLICE_ALIASES = ("MMM", "EWMM", "EWMD", "EWADD", "EWSUB", "MVM", "VDP", "JS",
                 "1DCONV", "SMMM", "FFT", "SORT", "HIST", "RMSNORM",
                 "FLASH_ATTN")


@dataclasses.dataclass
class HostEntry:
    host_name: str
    port: int = 8000
    mode: str = "ads_accel"
    max_slots: int = 1          # cards on this host

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HostEntry":
        return cls(host_name=d["host_name"], port=int(d.get("port", 8000)),
                   mode=d.get("mode", "ads_accel"),
                   max_slots=int(d.get("max_slots", 1)))


@dataclasses.dataclass
class FuncEntry:
    func_alias: str
    sw_fid: str
    func_repl: int = 1
    platform_id: str = "rr_scat"      # recommendation strategy for this alias
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FuncEntry":
        known = {"func_alias", "sw_fid", "func_repl", "platform_id"}
        return cls(func_alias=d["func_alias"], sw_fid=str(d["sw_fid"]),
                   func_repl=int(d.get("func_repl", 1)),
                   platform_id=d.get("platform_id", "rr_scat"),
                   overrides={k: v for k, v in d.items() if k not in known})


@dataclasses.dataclass
class Manifest:
    host_list: List[HostEntry] = dataclasses.field(default_factory=list)
    func_list: List[FuncEntry] = dataclasses.field(default_factory=list)
    platform_list: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Manifest":
        return cls(
            host_list=[HostEntry.from_dict(h) for h in d.get("host_list", [])],
            func_list=[FuncEntry.from_dict(f) for f in d.get("func_list", [])],
            platform_list=list(d.get("platform_list", [])),
        )

    @classmethod
    def from_json(cls, path) -> "Manifest":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def to_dict(self) -> Dict[str, Any]:
        # overrides go back to the top level of their func entry (Table I
        # form), so from_dict(to_dict(m)) reproduces m; the reference nests
        # them under an "overrides" key, which from_dict then nests again
        funcs = []
        for f in self.func_list:
            d = dataclasses.asdict(f)
            d.update(d.pop("overrides"))
            funcs.append(d)
        return {
            "host_list": [dataclasses.asdict(h) for h in self.host_list],
            "func_list": funcs,
            "platform_list": list(self.platform_list),
        }

    def to_json(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    # -- queries ---------------------------------------------------------------
    def func(self, alias: str) -> Optional[FuncEntry]:
        for f in self.func_list:
            if f.func_alias == alias:
                return f
        return None

    def total_slots(self) -> int:
        return sum(h.max_slots for h in self.host_list)

    def platform_preference(self) -> Optional[Sequence[str]]:
        for p in self.platform_list:
            if "platform_preference" in p:
                return tuple(p["platform_preference"])
        return None


def default_manifest() -> Manifest:
    """The port's shipped manifest: one local host with one H100, the
    registered aliases, and the hopper > aten > torch preference."""
    return Manifest(
        host_list=[HostEntry("localhost", 8000, "ads_accel", 1)],
        func_list=[
            FuncEntry(a, sw_fid=f"fid:{a.lower()}", platform_id="rr_scat")
            for a in SLICE_ALIASES
        ],
        platform_list=[{
            "platform_preference": ["hopper", "aten", "torch"],
            "recommendation": "round_robin",
        }],
    )
