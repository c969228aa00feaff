"""PyTorch/CUDA port of the hocuspocus_tpu merge plane.

A package of its own beside the JAX package, which stays the reference:
the serve path of the merge plane on one NVIDIA GPU over the unit arena
and the run-length arena, with each arena's integrate step as a
hand-written Hopper kernel (`csrc/integrate.cu`, `csrc/integrate_rle.cu`).
It imports torch and numpy, and nothing of the JAX package.
"""
