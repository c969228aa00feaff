"""PyTorch/CUDA port of the hocuspocus_tpu merge plane.

A package of its own beside the JAX package, which stays the reference:
the unit-arena serve path of the merge plane on one NVIDIA GPU, with the
integrate step as a hand-written Hopper kernel (`csrc/integrate.cu`).
It imports torch and numpy, and nothing of the JAX package.
"""
