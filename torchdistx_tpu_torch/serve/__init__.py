"""The serving runtime: paged KV cache, prefix cache and n-gram drafter,
the serving programs (CUDA graphs on the card), the continuous-batching
engine with deferred-init replica bring-up, and above it the fleet: N
replicas behind one router and autoscaler (:mod:`.fleet`, :mod:`.router`),
its guardrails (:mod:`.guardrails`) and blue-green weight rollover
(:mod:`.rollover`)::

    with ServeFleet("tiny", fleet_cfg=FleetConfig(min_replicas=2)) as fl:
        fl.start()
        out = fl.run([Request("r0", [1, 2, 3], max_new_tokens=8)])
"""

from .engine import Request, ServeEngine, oracle_generate, spin_up_replica
from .fleet import Autoscaler, FleetConfig, ReplicaHandle, ServeFleet
from .guardrails import (
    Brownout,
    CircuitBreaker,
    GuardrailConfig,
    QuarantineEntry,
    should_hedge,
)
from .kv_cache import KVCacheConfig, OutOfPages, PagedKVCache, init_pools
from .prefix import NgramDrafter, PrefixCache
from .programs import ResolvedServeConfig, ServeConfig, make_model, model_family
from .rollover import RollError, RolloverConfig, RolloverController
from .router import (
    AdmissionQueue,
    FleetRejected,
    Rejection,
    least_outstanding,
    prefix_affinity,
)

__all__ = [
    "AdmissionQueue",
    "Autoscaler",
    "Brownout",
    "CircuitBreaker",
    "FleetConfig",
    "FleetRejected",
    "GuardrailConfig",
    "KVCacheConfig",
    "NgramDrafter",
    "OutOfPages",
    "PagedKVCache",
    "PrefixCache",
    "QuarantineEntry",
    "Rejection",
    "ReplicaHandle",
    "Request",
    "ResolvedServeConfig",
    "RollError",
    "RolloverConfig",
    "RolloverController",
    "ServeConfig",
    "ServeEngine",
    "ServeFleet",
    "init_pools",
    "least_outstanding",
    "make_model",
    "model_family",
    "oracle_generate",
    "prefix_affinity",
    "should_hedge",
    "spin_up_replica",
]
