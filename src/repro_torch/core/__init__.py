"""Stannis core (port of :mod:`repro.core`): the paper's contributions.

C1 tuner.py         Algorithm 1 batch-size equalization
C2 load_balance.py  Eq. 1 epoch alignment + private-shard remedies
C3 privacy.py       placement manifests; private data never moves
C4 hetero.py        masked uniform batches + globally-weighted gradients
    topology.py     worker classes, fleet perf/energy model (Newport/host)
"""
from repro_torch.core.hetero import BatchSchedule, masked_mean_loss, schedule_from_tune
from repro_torch.core.load_balance import EpochPlan, eq1_dataset_size, plan_epoch
from repro_torch.core.privacy import PlacementManifest, Shard, place
from repro_torch.core.topology import Fleet, WorkerClass, paper_fleet, tpu_fleet
from repro_torch.core.tuner import DriftMonitor, TuneResult, tune

__all__ = [
    "BatchSchedule", "masked_mean_loss", "schedule_from_tune",
    "EpochPlan", "eq1_dataset_size", "plan_epoch",
    "PlacementManifest", "Shard", "place",
    "Fleet", "WorkerClass", "paper_fleet", "tpu_fleet",
    "DriftMonitor", "TuneResult", "tune",
]
