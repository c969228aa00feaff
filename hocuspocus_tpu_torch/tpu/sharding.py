"""The device roster of the multi-device cell plane (tpu/cells.py).

The port of `enumerate_devices` from the JAX package's `tpu/sharding.py`,
in torch terms. The rest of that module, the mesh and its sharded step
functions (`make_mesh`, `make_sharded_*`), is not ported yet (ROADMAP.md,
Queue A item 7b).
"""

from __future__ import annotations

from typing import Optional

import torch


def enumerate_devices(count: int = 0, device: Optional[str] = None) -> "list[torch.device]":
    """The device roster for the per-card cell plane.

    `device` None or "cuda" lists the visible cards, `cuda:0` to
    `cuda:n-1` (`torch.cuda.device_count()`), and raises when CUDA is not
    available; "cpu" lists the one CPU device. count <= 0 means every
    device of that roster; a count larger than the roster wraps (cell i
    on device i % n), so one card or the CPU still runs an N-cell plane;
    a smaller count uses the first `count` devices."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the multi-device cell plane needs a CUDA device; pass "
                "device='cpu' to run its cells on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"no device roster for {device!r}: pass 'cuda' or 'cpu'")
    if count <= 0:
        return list(devices)
    return [devices[i % len(devices)] for i in range(count)]
