"""Persistent multi-model serving daemon + replica fleet (PyTorch port
of `lightgbm_tpu/serving/`, the same names, wire and behaviour).

The layer over the device inference stack: a long-lived process that
owns the card and composes the bucket ladder of the tensor traversal
(inference/), a hot-swap model registry (registry.py), and a request
coalescer (coalescer.py) into sustained throughput with bounded tail
latency; and, above it, the serving FAULT DOMAIN: K replica daemons
under poll-based supervision (fleet.py) behind a router (router.py)
that retries across replicas with deadline propagation, sheds load when
the fleet saturates, and rolls new model versions out
replica-by-replica with canary auto-rollback.
`python -m lightgbm_tpu_torch serve` / `serve-fleet` are the CLI front
ends (on the card unless `device_type=cpu`); `ServingClient` the
in-process/TCP API.
"""

from .coalescer import Coalescer, ServeFuture, ServeRequest, ShedError
from .daemon import ServingClient, ServingDaemon, serve_counters_reset
from .fleet import (FleetAggregator, ReplicaEndpoint, ReplicaFleet,
                    ReplicaState)
from .frontend import (LineClient, ServeFrontend, ServeUdsFrontend,
                       start_frontend, start_uds_frontend)
from .registry import LoadHandle, ModelEntry, ModelRegistry
from .router import (NoReplicaError, OverloadedError, Router, RouterReply,
                     start_router_frontend)

__all__ = [
    "Coalescer", "ServeFuture", "ServeRequest", "ShedError",
    "ServingClient", "ServingDaemon", "serve_counters_reset",
    "FleetAggregator", "ReplicaEndpoint", "ReplicaFleet", "ReplicaState",
    "LineClient", "ServeFrontend", "ServeUdsFrontend", "start_frontend",
    "start_uds_frontend",
    "LoadHandle", "ModelEntry", "ModelRegistry",
    "NoReplicaError", "OverloadedError", "Router", "RouterReply",
    "start_router_frontend",
]
