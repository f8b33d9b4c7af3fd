"""Serving of the port: KV page pools, the continuous-batching scheduler,
the decode engine, and the gossip weight sync of a replica group."""
from repro_torch.serve.engine import ServeEngine, serve_requests
from repro_torch.serve.kv_cache import PagedKVSpec, PagePool
from repro_torch.serve.replica import ReplicaGroup
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ContinuousBatchingScheduler", "PagePool", "PagedKVSpec",
           "ReplicaGroup", "Request", "ServeEngine", "serve_requests"]
