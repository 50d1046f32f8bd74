"""Serving for the PyTorch port: token generation and mapping-as-a-service.

``Engine``/``ServeConfig`` (``serve.engine``) is the batched LM inference
engine (prefill + decode with a fixed-size KV cache) on torch.
``MappingService`` (``serve.service``) is the deployment-time DSE
service: a ``MappingRequest`` ("this network, this budget") in, the best
(arch, mapping) pair and its Pareto frontier out, backed by the
content-keyed run journal, a shared ``OverlapEngine`` and the staged
coalescing job queue (``serve.jobs``). ``MappingHTTPServer``
(``serve.transport``) exposes the same wire forms over HTTP. The mapping
half is numpy and byte-for-byte the reference package's (DESIGN.md
Sections 11 and 13).
"""
from .engine import Engine, ServeConfig
from .jobs import Job, JobQueue, QueueFull, QueueShutdown
from .service import MappingRequest, MappingResponse, MappingService
from .transport import MappingHTTPServer

__all__ = ["Engine", "ServeConfig", "Job", "JobQueue", "QueueFull",
           "QueueShutdown", "MappingRequest", "MappingResponse",
           "MappingService", "MappingHTTPServer"]
