"""PyTorch/CUDA port of lavie_tpu for NVIDIA Hopper.

Mirrors lavie_tpu's layout module for module. Plain tensor code is
PyTorch; the Pallas kernels become hand-written CUDA kernels under csrc/,
built with nvcc at first use. Imports nothing of JAX or lavie_tpu.
"""
