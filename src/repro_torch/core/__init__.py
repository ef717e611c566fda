"""HALO core runtime for the PyTorch/H100 port (mirrors ``repro.core``).

* :mod:`repro_torch.core.compute_object` — unified compute-object (C2MPI §IV-D)
* :mod:`repro_torch.core.registry`       — kernel attributes + selection (§IV-C)
* :mod:`repro_torch.core.manifest`       — unified configuration file (Table I)
* :mod:`repro_torch.core.agents`         — runtime + virtualization agents (§V)
* :mod:`repro_torch.core.scheduler`      — cost-model scheduler
* :mod:`repro_torch.core.tuning`         — shape-bucketed autotuning of the
  kernels' launch plans: TuningDB + sweep driver (DESIGN.md §9)
* :mod:`repro_torch.core.c2mpi`          — MPIX_* application interface (§IV)
* :mod:`repro_torch.core.collective`     — collective verbs over device groups of
  virtualization agents (DESIGN.md §10)
* :mod:`repro_torch.core.graph`          — execution graphs: DAG capture,
  cost-model placement, cross-substrate overlap (DESIGN.md §8)
* :mod:`repro_torch.core.fusion`         — graph-level kernel fusion + replayable
  compiled graphs (DESIGN.md §12)
* :mod:`repro_torch.core.portability`    — performance-portability metrics (§VI)

The names below are those of ``repro.core`` that the port has, its
tuning names (``TuneEntry``, ``TuneResult``, ``TuningDB``, ``autotune``,
``config_feasible``, ``shape_bucket``, ``tuning_key``) among them; the
reference's JAX agents (``JnpAgent``, ``XlaAgent``, ``PallasAgent``) have
no counterpart here — the port's
agents are ``TorchAgent``, ``AtenAgent``, ``HopperAgent`` and
``ShardedAgent`` (the reference's, on a ``torch.distributed`` mesh) in
:mod:`repro_torch.core.agents`.
"""
from .compute_object import BufferHandle, ComputeObject, as_compute_object
from .registry import (GLOBAL_REGISTRY, KernelAttributes, KernelRecord,
                       KernelRegistry, SelectionError, PLATFORM_PREFERENCE)
from .manifest import FuncEntry, HostEntry, Manifest, default_manifest
from .scheduler import CostModelScheduler, abstract_signature
from .tuning import (TuneEntry, TuneResult, TuningDB, autotune,
                     config_feasible, shape_bucket, tuning_key)
from .agents import (AgentDeadError, AgentState, ChildRank,
                     HaloCancelledError, HaloFuture, HealthConfig,
                     HealthMonitor, RuntimeAgent, ShardedAgent,
                     VirtualizationAgent)
from .c2mpi import (MPIX_Allgather, MPIX_Allreduce, MPIX_Bcast, MPIX_Claim,
                    MPIX_CommFree, MPIX_CommSplit, MPIX_CreateBuffer,
                    MPIX_Finalize, MPIX_Free, MPIX_Gather, MPIX_GraphBegin,
                    MPIX_GraphEnd, MPIX_IAllgather, MPIX_IAllreduce,
                    MPIX_IBcast, MPIX_IGather, MPIX_Initialize, MPIX_IRecv,
                    MPIX_IReduce, MPIX_IScatter, MPIX_ISend, MPIX_Recv,
                    MPIX_Reduce, MPIX_Scatter, MPIX_Send, MPIX_SendFwd,
                    MPIX_Test, MPIX_Wait, MPIX_Waitall, halo_dispatch,
                    halo_session)
from .collective import HaloComm, REDUCE_OPS
from .graph import (ExecutionGraph, GraphDependencyError, GraphError,
                    GraphNode, halo_graph)
from .fusion import (CompiledGraph, FusionRule, MemberSpec, compile_graph,
                     find_chains, fusion_rule, register_fusible)
from .portability import (KernelReport, Timing, overhead_ratio,
                          performance_penalty, portability_score, time_fn)

__all__ = [
    "BufferHandle", "ComputeObject", "as_compute_object",
    "GLOBAL_REGISTRY", "KernelAttributes", "KernelRecord", "KernelRegistry",
    "SelectionError", "PLATFORM_PREFERENCE",
    "FuncEntry", "HostEntry", "Manifest", "default_manifest",
    "CostModelScheduler", "abstract_signature",
    "TuneEntry", "TuneResult", "TuningDB", "autotune", "config_feasible",
    "shape_bucket", "tuning_key",
    "AgentDeadError", "AgentState", "ChildRank", "HaloCancelledError",
    "HaloFuture", "HealthConfig", "HealthMonitor", "RuntimeAgent",
    "ShardedAgent", "VirtualizationAgent",
    "MPIX_Allgather", "MPIX_Allreduce", "MPIX_Bcast", "MPIX_Claim",
    "MPIX_CommFree", "MPIX_CommSplit", "MPIX_CreateBuffer", "MPIX_Finalize",
    "MPIX_Free", "MPIX_Gather", "MPIX_GraphBegin", "MPIX_GraphEnd",
    "MPIX_IAllgather", "MPIX_IAllreduce", "MPIX_IBcast", "MPIX_IGather",
    "MPIX_Initialize", "MPIX_IRecv", "MPIX_IReduce", "MPIX_IScatter",
    "MPIX_ISend", "MPIX_Recv", "MPIX_Reduce", "MPIX_Scatter", "MPIX_Send",
    "MPIX_SendFwd", "MPIX_Test", "MPIX_Wait", "MPIX_Waitall",
    "halo_dispatch", "halo_session",
    "HaloComm", "REDUCE_OPS",
    "ExecutionGraph", "GraphDependencyError", "GraphError", "GraphNode",
    "halo_graph",
    "CompiledGraph", "FusionRule", "MemberSpec", "compile_graph",
    "find_chains", "fusion_rule", "register_fusible",
    "KernelReport", "Timing", "overhead_ratio", "performance_penalty",
    "portability_score", "time_fn",
]
