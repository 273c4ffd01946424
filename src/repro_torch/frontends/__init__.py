"""Model frontends.  This package holds the bundled **zoo**
(:mod:`repro_torch.frontends.zoo`) — LeNet-5, a tiny-VGG cascade, a
residual edge model and a strided ResNet-style trunk, registered in the
benchmark suite.  The ONNX reader and the model-card format of the
reference package are not ported yet.
"""
from .zoo import ZOO

__all__ = ["ZOO"]
