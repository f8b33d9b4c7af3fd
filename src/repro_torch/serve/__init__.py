"""Paged serving of the port: KV page pools, the continuous-batching
scheduler and the decode engine."""
from repro_torch.serve.engine import ServeEngine, serve_requests
from repro_torch.serve.kv_cache import PagedKVSpec, PagePool
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ContinuousBatchingScheduler", "PagePool", "PagedKVSpec",
           "Request", "ServeEngine", "serve_requests"]
