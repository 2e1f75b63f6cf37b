"""The serving runtime: paged KV cache, prefix cache and n-gram drafter,
the serving programs (CUDA graphs on the card), and the
continuous-batching engine with deferred-init replica bring-up."""

from .engine import Request, ServeEngine, oracle_generate, spin_up_replica
from .kv_cache import KVCacheConfig, OutOfPages, PagedKVCache, init_pools
from .prefix import NgramDrafter, PrefixCache
from .programs import ResolvedServeConfig, ServeConfig, make_model, model_family

__all__ = [
    "KVCacheConfig",
    "NgramDrafter",
    "OutOfPages",
    "PagedKVCache",
    "PrefixCache",
    "Request",
    "ResolvedServeConfig",
    "ServeConfig",
    "ServeEngine",
    "init_pools",
    "make_model",
    "model_family",
    "oracle_generate",
    "spin_up_replica",
]
