"""The merge plane, its kernels, its serving path, its residency manager
and supervisor, and the server extensions that put live documents on it,
in PyTorch."""

from .integrate import compact_doc_rows_fast, compact_doc_rows_rle_fast
from .merge_plane import LogRec, MergePlane, PlaneDoc, TpuMergeExtension
from .residency import EvictedDoc, ResidencyManager
from .serving import PlaneServing, SyncFrameCache, TpuSyncSource
from .supervisor import CircuitBreaker, PlaneSupervisor, SupervisedTpuMergeExtension

__all__ = [
    "CircuitBreaker",
    "EvictedDoc",
    "LogRec",
    "MergePlane",
    "PlaneDoc",
    "PlaneServing",
    "PlaneSupervisor",
    "ResidencyManager",
    "SupervisedTpuMergeExtension",
    "SyncFrameCache",
    "TpuMergeExtension",
    "TpuSyncSource",
    "compact_doc_rows_fast",
    "compact_doc_rows_rle_fast",
]
