"""Execution planning for the port: ``ExecutionPolicy`` (how to run),
``ConvLayerPlan`` / ``ModelPlan`` (per-layer schedules),
``execute.run_conv2d`` (the one dispatch site) and the plan autotuner
(``autotune``: per-layer winners, persisted)."""

from repro_torch.engine.plan import (ConvLayerPlan, ModelPlan,
                                     plan_conv_layer, plan_model)
from repro_torch.engine.policy import (SUBSTRATES, TUNING_MODES,
                                       ExecutionPolicy, fp32_ieee,
                                       resolve_device)
from repro_torch.engine.autotune import (TuneResult, tune_conv_layer,
                                         tune_model)

__all__ = [
    "ConvLayerPlan",
    "ExecutionPolicy",
    "ModelPlan",
    "SUBSTRATES",
    "TUNING_MODES",
    "TuneResult",
    "fp32_ieee",
    "plan_conv_layer",
    "plan_model",
    "resolve_device",
    "tune_conv_layer",
    "tune_model",
]
