"""PyTorch / CUDA port of the multitask bone-tumor framework for NVIDIA Hopper.

The JAX package ``multitask_bonetumor_yolo_tpu`` is the reference; this
package mirrors its layout (``core/``, ``ops/``, ``ops/kernels/``,
``models/``, ``cli/``) and keeps its public layouts (NHWC tensors, anchors
flattened NHWC row-major) so that every function can be held against its JAX
counterpart. Inside, activations are NCHW tensors in ``channels_last`` memory,
so cuDNN and the hand-written ConvNeXt-block kernel both see NHWC bytes.

This package imports ``torch`` and ``numpy`` only, never JAX.
"""
