"""mumpy_tpu_torch — PyTorch + CUDA port of the Mumpy serving path.

The JAX package ``mumpy_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``utils/``) and imports no JAX.  The matrix
products, attention and sampling of the Swin blocks and block pairs,
cross-view blocks, global-ViT layers and deformable cross-view attention run
through kernels written by hand for Hopper (``csrc/*.cu``); every other op is
plain PyTorch.
"""
