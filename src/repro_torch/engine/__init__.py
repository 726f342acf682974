"""Execution planning for the port: ``ExecutionPolicy`` (how to run),
``ConvLayerPlan`` / ``ModelPlan`` (per-layer schedules) and
``execute.run_conv2d`` (the one dispatch site)."""

from repro_torch.engine.plan import (ConvLayerPlan, ModelPlan,
                                     plan_conv_layer, plan_model)
from repro_torch.engine.policy import (SUBSTRATES, ExecutionPolicy,
                                       fp32_ieee, resolve_device)

__all__ = [
    "ConvLayerPlan",
    "ExecutionPolicy",
    "ModelPlan",
    "SUBSTRATES",
    "fp32_ieee",
    "plan_conv_layer",
    "plan_model",
    "resolve_device",
]
