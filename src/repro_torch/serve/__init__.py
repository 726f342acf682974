"""The port's serving core: ``Server`` (threaded admission, flush worker,
inline open loop) over ``ServeEngine`` (one warmed executable per
(ModelPlan, batch bucket)), with pad-and-bucket admission
(``BucketBatcher``), ``ServeConfig`` and ``ServeMetrics`` copied from the
JAX package."""

from repro_torch.serve.batching import BucketBatcher, Request, pad_batch
from repro_torch.serve.config import DATAPATHS, OVERLOAD_POLICIES, ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultPlan, Lane, RetryPolicy
from repro_torch.serve.metrics import (SCHEMA_VERSION, ServeMetrics,
                                       device_stamp, stamp_payload)
from repro_torch.serve.server import Server

__all__ = [
    "BucketBatcher",
    "DATAPATHS",
    "FaultPlan",
    "Lane",
    "OVERLOAD_POLICIES",
    "Request",
    "RetryPolicy",
    "SCHEMA_VERSION",
    "Server",
    "ServeConfig",
    "ServeEngine",
    "ServeMetrics",
    "device_stamp",
    "pad_batch",
    "stamp_payload",
]
