"""PyTorch/CUDA port of hocuspocus_tpu.

A package of its own beside the JAX package, which stays the reference:
the Hocuspocus server core, wire protocol and client provider, and
`TpuMergeExtension`, which puts live documents on the merge plane on one
NVIDIA GPU over the unit arena or the run-length arena, with each arena's
integrate step as a hand-written Hopper kernel (`csrc/integrate.cu`,
`csrc/integrate_rle.cu`). It imports torch, numpy and the standard
library (aiohttp only for the websocket server and socket), and nothing
of the JAX package.
"""

__version__ = "0.1.0"
