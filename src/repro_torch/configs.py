"""The CNN configs the port serves, full width and smoke size.

Mirrors ``repro/configs/vgg16.py``, ``alexnet.py`` and the CNN registries
of ``repro/configs/__init__.py``; the smoke shapes are the same.
"""
from repro_torch.core.model import ConvLayerSpec
from repro_torch.nn.conv import ALEXNET_CNN, VGG16_CNN, CNNConfig

#: reduced VGG-16: same family (3x3 stacks + pools), tiny maps
VGG16_SMOKE = CNNConfig(
    "vgg16-smoke",
    layers=(
        ConvLayerSpec("CL1", 16, 16, 3, 3, 8),
        ConvLayerSpec("CL2", 16, 16, 3, 8, 8),
        ConvLayerSpec("CL3", 8, 8, 3, 8, 16),
    ),
    pool_after=(1,), classifier=(32,), n_classes=10, input_hw=(16, 16))

#: reduced AlexNet keeping the large-kernel + stride structure
ALEXNET_SMOKE = CNNConfig(
    "alexnet-smoke",
    layers=(
        # 23x23 --11x11 s4--> 4x4 --5x5 p2--> 4x4 --3x3 p1--> 4x4
        ConvLayerSpec("CL1", 23, 23, 11, 3, 8, stride=4, pad=0),
        ConvLayerSpec("CL2", 4, 4, 5, 8, 16, pad=2),
        ConvLayerSpec("CL3", 4, 4, 3, 16, 16, pad=1),
    ),
    pool_after=(), classifier=(32,), n_classes=10, input_hw=(23, 23))

CNN_REGISTRY = {"vgg16": VGG16_CNN, "alexnet": ALEXNET_CNN}
CNN_SMOKES = {"vgg16": VGG16_SMOKE, "alexnet": ALEXNET_SMOKE}
