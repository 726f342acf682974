"""The port's serving core: ``Server`` (threaded admission, flush worker,
inline open loop) over ``ServeEngine`` (one warmed executable per
(ModelPlan, batch bucket)), with pad-and-bucket admission
(``BucketBatcher``), ``ServeConfig`` and ``ServeMetrics`` copied from the
JAX package.  The fault-injection plane lives in ``serve.faults``: a
seeded frozen ``FaultPlan`` (armed through ``ServeConfig.faults``), the
degradation ``Lane`` ladder with its ``CircuitBreaker``, the
bounded-backoff ``RetryPolicy`` and the checksummed ``PackedWire`` int5
payload."""

from repro_torch.serve.batching import BucketBatcher, Request, pad_batch
from repro_torch.serve.config import DATAPATHS, OVERLOAD_POLICIES, ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import (CircuitBreaker, FaultInjector,
                                      FaultPlan, InjectedFault, Lane,
                                      NonFiniteOutput, PackedWire,
                                      RetryPolicy, TransientFault,
                                      WorkerCrash)
from repro_torch.serve.metrics import (SCHEMA_VERSION, ServeMetrics,
                                       device_stamp, stamp_payload)
from repro_torch.serve.server import Server

__all__ = [
    "BucketBatcher",
    "CircuitBreaker",
    "DATAPATHS",
    "FaultInjector",
    "FaultPlan",
    "InjectedFault",
    "Lane",
    "NonFiniteOutput",
    "OVERLOAD_POLICIES",
    "PackedWire",
    "Request",
    "RetryPolicy",
    "SCHEMA_VERSION",
    "Server",
    "ServeConfig",
    "ServeEngine",
    "ServeMetrics",
    "TransientFault",
    "WorkerCrash",
    "device_stamp",
    "pad_batch",
    "stamp_payload",
]
