"""PyTorch / CUDA port of codlad_tpu for one NVIDIA H100 (Hopper).

Mirrors the JAX package's layout (nn/, models/, gen/, kernels/, geometry/,
data/, eval/, convert/). It imports torch, numpy and the standard library,
never JAX or the JAX package. Entry points run on the card unless the
caller passes device="cpu".
"""
