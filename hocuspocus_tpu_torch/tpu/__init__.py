"""The merge plane, its kernels and its serving path, in PyTorch."""

from .merge_plane import LogRec, MergePlane, PlaneDoc
from .serving import PlaneServing, SyncFrameCache, TpuSyncSource

__all__ = [
    "LogRec",
    "MergePlane",
    "PlaneDoc",
    "PlaneServing",
    "SyncFrameCache",
    "TpuSyncSource",
]
