"""The merge plane, its kernels, its serving path, its residency manager
and supervisor, and the server extensions that put live documents on it,
in PyTorch."""

from .integrate import compact_doc_rows_fast, compact_doc_rows_rle_fast
from .merge_plane import LogRec, MergePlane, PlaneDoc, TpuMergeExtension
from .residency import EvictedDoc, ResidencyManager
from .serving import PlaneServing, SyncFrameCache, TpuSyncSource
from .supervisor import CircuitBreaker, PlaneSupervisor, SupervisedTpuMergeExtension


class _NotPortedYet:
    """A name of the JAX package's `tpu` whose code is not ported yet:
    importable, so callers resolve it, and raising when constructed."""

    what = ""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} ({self.what}) is not ported yet: "
            "ROADMAP.md, Queue A item 7"
        )


class ShardedTpuMergeExtension(_NotPortedYet):
    what = "doc-sharded merge planes"


class MultiDeviceMergeExtension(_NotPortedYet):
    what = "per-card merge cells"


__all__ = [
    "CircuitBreaker",
    "EvictedDoc",
    "LogRec",
    "MergePlane",
    "MultiDeviceMergeExtension",
    "PlaneDoc",
    "PlaneServing",
    "PlaneSupervisor",
    "ResidencyManager",
    "ShardedTpuMergeExtension",
    "SupervisedTpuMergeExtension",
    "SyncFrameCache",
    "TpuMergeExtension",
    "TpuSyncSource",
    "compact_doc_rows_fast",
    "compact_doc_rows_rle_fast",
]
