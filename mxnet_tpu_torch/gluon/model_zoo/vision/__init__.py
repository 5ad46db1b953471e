"""Model zoo: vision models (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``; ResNet v1 so far)."""
from .resnet import (BasicBlockV1, BottleneckV1, ResNetV1, get_resnet,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1)

__all__ = ["get_model", "get_resnet", "ResNetV1", "BasicBlockV1",
           "BottleneckV1", "resnet18_v1", "resnet34_v1", "resnet50_v1",
           "resnet101_v1", "resnet152_v1"]

_models = {
    "resnet18_v1": resnet18_v1,
    "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1,
    "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
}


def get_model(name, **kwargs):
    """A model by name, e.g. ``get_model("resnet50_v1", classes=1000,
    layout="NHWC", ctx=cpu())``. ``ctx`` is the device ``initialize`` uses
    by default (``cuda`` if None)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not ported; ported: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
