"""The paper's own workload: VGG-16 / AlexNet CNN inference through the
3D-TrIM conv kernels (the counterpart of ``repro/configs/trim_cnn.py``).
Not an LM architecture: served by ``launch/serve_conv.py``."""

from repro_torch.core.model import alexnet_layers, vgg16_layers  # noqa: F401

ARCH_ID = "trim-cnn"
