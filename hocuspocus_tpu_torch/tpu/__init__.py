"""The merge plane, its kernels, its serving path, its residency manager
and supervisor, the per-device merge cells, and the server extensions
that put live documents on them, in PyTorch."""

from .cells import DevicePlacement, MultiDeviceMergeExtension, plan_migrations
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
            "ROADMAP.md, Queue A item 7b"
        )


class ShardedTpuMergeExtension(_NotPortedYet):
    what = "doc-sharded merge planes"



__all__ = [
    "CircuitBreaker",
    "DevicePlacement",
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
    "plan_migrations",
]
