"""The merge plane, its kernels, its serving path and the server
extension that puts live documents on it, in PyTorch."""

from .merge_plane import LogRec, MergePlane, PlaneDoc, TpuMergeExtension
from .serving import PlaneServing, SyncFrameCache, TpuSyncSource

__all__ = [
    "LogRec",
    "MergePlane",
    "PlaneDoc",
    "PlaneServing",
    "SyncFrameCache",
    "TpuMergeExtension",
    "TpuSyncSource",
]
