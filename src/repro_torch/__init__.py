"""PyTorch / CUDA port of the 3D-TrIM reproduction for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Layouts follow the JAX package: activations NHWC, conv weights
``(K, K, Cin/groups, Cout)``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device  # noqa: F401
