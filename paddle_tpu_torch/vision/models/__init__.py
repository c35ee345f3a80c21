"""Model zoo (reference: python/paddle/vision/models/__init__.py)."""
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d, wide_resnet50_2, wide_resnet101_2)
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .squeezenet import (  # noqa: F401
    SqueezeNet, squeezenet1_0, squeezenet1_1)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264)
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .mobilenetv3 import (  # noqa: F401
    MobileNetV3Small, MobileNetV3Large, mobilenet_v3_small,
    mobilenet_v3_large)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish)

__all__ = [
    "LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "wide_resnet50_2", "wide_resnet101_2", "AlexNet", "alexnet", "VGG",
    "vgg11", "vgg13", "vgg16", "vgg19", "SqueezeNet", "squeezenet1_0",
    "squeezenet1_1", "GoogLeNet", "googlenet", "InceptionV3",
    "inception_v3", "DenseNet", "densenet121", "densenet161",
    "densenet169", "densenet201", "densenet264", "MobileNetV1",
    "mobilenet_v1", "MobileNetV2", "mobilenet_v2", "MobileNetV3Small",
    "MobileNetV3Large", "mobilenet_v3_small", "mobilenet_v3_large",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]
