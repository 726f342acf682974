"""The paper's conv layer tables: ``ConvLayerSpec`` and the VGG-16 /
AlexNet stacks of Tables I and II, in the paper's nomenclature.

A copy of the layer descriptors of ``repro.core.trim.model`` (the
analytical cycle and access models there are not part of the port).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ConvLayerSpec:
    """One convolutional layer, in the paper's nomenclature.

    H_I, W_I : input feature-map height/width (pre-padding)
    K        : kernel size (square)
    M        : input channels  (# ifmaps)
    N        : output channels (# filters / ofmaps)
    stride   : convolution stride
    pad      : symmetric zero padding
    """

    name: str
    H_I: int
    W_I: int
    K: int
    M: int
    N: int
    stride: int = 1
    pad: Optional[int] = None  # default: 'same' for stride 1 -> K//2

    @property
    def padding(self) -> int:
        return self.K // 2 if self.pad is None else self.pad

    @property
    def H_O(self) -> int:
        return (self.H_I + 2 * self.padding - self.K) // self.stride + 1

    @property
    def W_O(self) -> int:
        return (self.W_I + 2 * self.padding - self.K) // self.stride + 1


VGG16_LAYERS: Tuple[ConvLayerSpec, ...] = (
    ConvLayerSpec("CL1", 224, 224, 3, 3, 64),
    ConvLayerSpec("CL2", 224, 224, 3, 64, 64),
    ConvLayerSpec("CL3", 112, 112, 3, 64, 128),
    ConvLayerSpec("CL4", 112, 112, 3, 128, 128),
    ConvLayerSpec("CL5", 56, 56, 3, 128, 256),
    ConvLayerSpec("CL6", 56, 56, 3, 256, 256),
    ConvLayerSpec("CL7", 56, 56, 3, 256, 256),
    ConvLayerSpec("CL8", 28, 28, 3, 256, 512),
    ConvLayerSpec("CL9", 28, 28, 3, 512, 512),
    ConvLayerSpec("CL10", 28, 28, 3, 512, 512),
    ConvLayerSpec("CL11", 14, 14, 3, 512, 512),
    ConvLayerSpec("CL12", 14, 14, 3, 512, 512),
    ConvLayerSpec("CL13", 14, 14, 3, 512, 512),
)

ALEXNET_LAYERS: Tuple[ConvLayerSpec, ...] = (
    ConvLayerSpec("CL1", 227, 227, 11, 3, 96, stride=4, pad=0),
    ConvLayerSpec("CL2", 27, 27, 5, 48, 256, pad=2),
    ConvLayerSpec("CL3", 13, 13, 3, 256, 384, pad=1),
    ConvLayerSpec("CL4", 13, 13, 3, 192, 384, pad=1),
    ConvLayerSpec("CL5", 13, 13, 3, 192, 256, pad=1),
)
