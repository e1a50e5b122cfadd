"""`repro_torch.api` — the public, staged entry points of the port.

    from repro_torch.api import Session, SessionConfig, FleetSpec

    spec = FleetSpec.demo(n_csds=2)
    session = Session(
        model=model, optimizer=adamw(), fleet=spec,
        data=DataConfig(vocab=cfg.vocab, seq_len=32),
        shards=spec.shards(private_per_worker={"csd": 64}, public=4096),
        config=SessionConfig(total_steps=20),          # device="cuda" by default
    )
    report = session.run()          # tune -> plan -> place -> shard -> compile -> train

Serving: :class:`ServeSession` in :mod:`repro_torch.api.serving`.
"""
from repro_torch.api.artifacts import (
    CompiledStep, ReplanResult, ShardingPlan, TrainReport, TunePlan,
)
from repro_torch.api.callbacks import CallbackRegistry
from repro_torch.api.events import DriftDetected, FleetEvent, WorkerJoined, WorkerLost
from repro_torch.api.fleet import FleetSpec
from repro_torch.api.membership import (
    DirMembershipSource, ElasticController, HeartbeatWriter, MemberInfo,
    MembershipWatcher,
)
from repro_torch.api.serving import GenerateResult, ServeSession
from repro_torch.api.session import Session, SessionConfig
from repro_torch.storage import DeviceFleet, FleetManifest, StorageSpec

__all__ = [
    "CallbackRegistry",
    "CompiledStep",
    "DeviceFleet",
    "DirMembershipSource",
    "DriftDetected",
    "ElasticController",
    "FleetEvent",
    "FleetManifest",
    "FleetSpec",
    "GenerateResult",
    "HeartbeatWriter",
    "MemberInfo",
    "MembershipWatcher",
    "ReplanResult",
    "ServeSession",
    "Session",
    "SessionConfig",
    "ShardingPlan",
    "StorageSpec",
    "TrainReport",
    "TunePlan",
    "WorkerJoined",
    "WorkerLost",
]
