"""Training and LM serving steps and the training loop on one device
(port of the single-device part of ``repro/distributed``; meshes,
sharding and compressed gradient reduction belong to a later slice)."""

from repro_torch.distributed.steps import (StepConfig, make_decode_step,
                                           make_prefill_step,
                                           make_train_state, make_train_step)
from repro_torch.distributed.trainer import (StragglerMonitor,
                                             TrainLoopConfig, train_loop)

__all__ = [
    "StepConfig",
    "StragglerMonitor",
    "TrainLoopConfig",
    "make_decode_step",
    "make_prefill_step",
    "make_train_state",
    "make_train_step",
    "train_loop",
]
