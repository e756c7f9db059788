"""PyTorch/CUDA port of firedancer_tpu's device path, for NVIDIA Hopper.

Imports torch and numpy only, never jax or firedancer_tpu.  Entry points
take `device=None`, meaning the CUDA card; pass device="cpu" to run the
plain-torch versions.  Kernels live in csrc/ and are built by
utils/kbuild.py at first use.
"""
