"""`FleetSpec`: declarative fleet construction with named presets (port of
:mod:`repro.api.fleet`, without the cluster and sharding-rule knobs, which
arrive with the port's multi-device slice).

Every driver used to hand-roll its own ``WorkerClass(...)`` tuple (five
slightly-divergent copies across launch/, examples/, and tests/).  A
``FleetSpec`` is the one place fleet shapes are described: presets reproduce
the paper's AIC server (``FleetSpec.paper``) and the laptop-scaled demo rig
(``FleetSpec.demo``); ``FleetSpec.custom().add(...)`` covers everything else.

A spec is immutable; ``add`` returns a new spec, so specs chain:

    spec = FleetSpec.custom("bench").add("fast", 1, 100.0, 8, 64,
                                         active_power=100.0)
    fleet = spec.build()
    shards = spec.shards(private_per_worker={"csd": 256}, public=65536)
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Tuple

from repro_torch.core.privacy import Shard
from repro_torch.core.topology import Fleet, WorkerClass, paper_fleet, tpu_fleet
from repro_torch.storage import StorageSpec


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Immutable description of a heterogeneous fleet.

    ``storage`` selects the data plane: which
    :class:`~repro_torch.storage.StorageDevice` backend every worker's device
    uses (``synthetic`` | ``flash``); see :meth:`with_storage`.
    """

    classes: Tuple[WorkerClass, ...] = ()
    name: str = "custom"
    storage: StorageSpec = dataclasses.field(default_factory=StorageSpec)

    # -- presets -----------------------------------------------------------

    @classmethod
    def paper(cls, n_csds: int = 24, network: str = "mobilenetv2") -> "FleetSpec":
        """The paper's AIC server: 1 Xeon host + N Newport CSDs (Table I/II)."""
        return cls(classes=paper_fleet(n_csds, network).classes, name="paper")

    @classmethod
    def tpu(cls, n_fast_pods: int = 1, n_slow_pods: int = 1, **kw) -> "FleetSpec":
        """Mixed-generation TPU fleet (fast + slow pod classes)."""
        return cls(classes=tpu_fleet(n_fast_pods, n_slow_pods, **kw).classes,
                   name="tpu")

    @classmethod
    def demo(
        cls,
        n_csds: int = 2,
        *,
        host_tput: float = 100.0,
        csd_tput: float = 25.0,
        host_saturation: int = 8,
        csd_saturation: int = 2,
        host_max_batch: int = 16,
        csd_max_batch: int = 4,
        host_power: float = 400.0,
        csd_power: float = 7.0,
        host_idle: float = 0.0,
        csd_idle: float = 0.0,
        host_link: float = 8.0,
        csd_link: float = 2.0,
    ) -> "FleetSpec":
        """Paper-shaped fleet (1 host + N CSD-class workers), laptop-scaled."""
        host = WorkerClass(
            name="host", count=1, peak_throughput=host_tput,
            saturation_batch=host_saturation, max_batch=host_max_batch,
            active_power=host_power, idle_power=host_idle,
            link_bandwidth=host_link,
        )
        csd = WorkerClass(
            name="csd", count=n_csds, peak_throughput=csd_tput,
            saturation_batch=csd_saturation, max_batch=csd_max_batch,
            active_power=csd_power, idle_power=csd_idle,
            link_bandwidth=csd_link,
        )
        return cls(classes=(host, csd), name="demo")

    @classmethod
    def custom(cls, name: str = "custom") -> "FleetSpec":
        return cls(classes=(), name=name)

    # -- builder -----------------------------------------------------------

    def add(
        self,
        name: str,
        count: int,
        peak_throughput: float,
        saturation_batch: int,
        max_batch: int,
        *,
        active_power: float,
        idle_power: float = 0.0,
        link_bandwidth: float = 1.0,
    ) -> "FleetSpec":
        """Append a worker class; returns a NEW spec (specs are immutable)."""
        wc = WorkerClass(
            name=name, count=count, peak_throughput=peak_throughput,
            saturation_batch=saturation_batch, max_batch=max_batch,
            active_power=active_power, idle_power=idle_power,
            link_bandwidth=link_bandwidth,
        )
        return dataclasses.replace(self, classes=self.classes + (wc,))

    def with_storage(self, backend: str, **kw) -> "FleetSpec":
        """Select the storage backend for every device in the fleet:

            FleetSpec.demo(3).with_storage("flash", root="/data/spool")
        """
        return dataclasses.replace(
            self, storage=StorageSpec(backend=backend, **kw)
        )

    def build(self) -> Fleet:
        if not self.classes:
            raise ValueError(f"FleetSpec {self.name!r} has no worker classes")
        return Fleet(classes=self.classes)

    # -- shard layout helper ----------------------------------------------

    def shards(
        self,
        *,
        private_per_worker: Optional[Mapping[str, int]] = None,
        public: int = 0,
        public_id: str = "public",
        prefix: str = "private",
    ) -> List[Shard]:
        """Standard shard layout: per-worker private shards + one public pool.

        ``private_per_worker`` maps a class name to the samples each of its
        workers owns privately (the paper's on-flash TinyImageNet slices);
        ``public`` is the shared pool size.
        """
        out: List[Shard] = []
        for cls in self.classes:
            n = (private_per_worker or {}).get(cls.name, 0)
            if n <= 0:
                continue
            for i in range(cls.count):
                worker = f"{cls.name}/{i}"
                out.append(Shard(f"{prefix}-{worker}", n, True, worker))
        if public > 0:
            out.append(Shard(public_id, public, False))
        return out
