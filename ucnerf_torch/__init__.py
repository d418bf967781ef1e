"""ucnerf_torch: the PyTorch + CUDA port of ucnerf_tpu for one NVIDIA H100.

The JAX package ``ucnerf_tpu`` stays the reference.  This package imports
torch, numpy and the standard library only; it keeps its own copies of
what it needs, mirrors ``ucnerf_tpu``'s module layout, and keeps its
channel-last public layouts.  Entry points run on the card unless the
caller asks for the CPU.
"""
