"""PyTorch/CUDA port of hocuspocus_tpu.

A package of its own beside the JAX package, which stays the reference:
the Hocuspocus server core, wire protocol and client provider, its
extensions, and `TpuMergeExtension`, which puts live documents on the
merge plane on one NVIDIA GPU over the unit arena or the run-length
arena, with each arena's integrate step as a hand-written Hopper kernel
(`csrc/integrate.cu`, `csrc/integrate_rle.cu`). It imports torch, numpy
and the standard library (aiohttp only where a request is made or a
socket served: the websocket server and socket, Webhook and S3 calls,
the Metrics endpoints), and nothing of the JAX package.

Layering, as the JAX package's:
  L0/L1  hocuspocus_tpu_torch.crdt        — Y.js-compatible CRDT engine + binary codec
         hocuspocus_tpu_torch.native      — C++ update codec and text lane (built with g++)
         hocuspocus_tpu_torch.protocol    — sync/awareness/auth wire protocols
  L2     hocuspocus_tpu_torch.server      — asyncio server core (hook bus, documents)
  L3     hocuspocus_tpu_torch.provider    — client provider (reconnect, multiplexing, history client)
  L4     hocuspocus_tpu_torch.extensions  — database/sqlite/s3/redis/logger/throttle/webhook/history
         hocuspocus_tpu_torch.net         — RESP client and in-process mini-redis
  L5     hocuspocus_tpu_torch.transformer — ProseMirror/Tiptap JSON <-> doc
  L6     hocuspocus_tpu_torch.tpu         — batched merge plane on the GPU (PyTorch + CUDA)
         hocuspocus_tpu_torch.observability, .storage — metrics, profiler, SLO; WAL, durability
"""

__version__ = "0.1.0"

# the JAX package's top-level names, resolved lazily: importing the
# package pulls in neither the server core nor torch
_LAZY = {
    "Configuration": ("server", "Configuration"),
    "Extension": ("server", "Extension"),
    "Hocuspocus": ("server", "Hocuspocus"),
    "Payload": ("server", "Payload"),
    "Server": ("server", "Server"),
    "HocuspocusProvider": ("provider", "HocuspocusProvider"),
    "HocuspocusProviderWebsocket": ("provider", "HocuspocusProviderWebsocket"),
    "Doc": ("crdt", "Doc"),
    "Metrics": ("observability", "Metrics"),
    "TpuMergeExtension": ("tpu", "TpuMergeExtension"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attribute = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attribute)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [*_LAZY, "__version__"]
