"""The warp path's window and the launch arguments of the Hopper kernels.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what the dispatcher decides and hands to them is checked here: the
window it picks for a row width, that the plane's shape fits one wave
at that window, and that every launch passes exactly the C entry
point's parameters.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hocuspocus_tpu_torch.tpu import integrate as ti
from hocuspocus_tpu_torch.tpu import kernels as tk
from hocuspocus_tpu_torch.tpu import kernels_rle as tr

CSRC = Path(ti.__file__).resolve().parent.parent / "csrc"
# H100 SXM: SMs, shared memory a block can opt in to, registers an SM
SMS, SMEM_PER_SM, REGS_PER_SM = 132, 232_448, 65_536
# source, entry point, bytes a row element takes in the window
KERNELS = {
    "unit": ("integrate.cu", "hp_integrate_rows", 17),
    "rle": ("integrate_rle.cu", "hp_integrate_rle_rows", 21),
}


def constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


@pytest.mark.parametrize("width", [1, 16, 64, 511, 512, 513, 1024, 4096, 20_000])
def test_window_is_never_wider_than_the_row(width):
    window = ti._warp_window(width)
    assert 0 < window <= width
    assert window == min(width, ti.WARP_WINDOW)


@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_plane_shape_is_one_wave_at_the_window(arena):
    """The plane routes 1,024 rows of width 4096: at the window the
    dispatcher picks, every row's warp is resident at once on 132 SMs,
    by shared memory and by the registers the launch bounds allow."""
    source_name, _entry, element_bytes = KERNELS[arena]
    source = (CSRC / source_name).read_text()
    rows_per_cta = constant(source, "kWarpRows")
    # two CTAs an SM: the compiler keeps each thread to 65,536 / 512 = 128 registers
    assert "__launch_bounds__(kWarpRows * 32, 2)" in source
    assert REGS_PER_SM // (2 * rows_per_cta * 32) >= 64
    pool = rows_per_cta * ti._warp_window(4096) * element_bytes
    ctas_per_sm = min(SMEM_PER_SM // pool, 2)
    assert ctas_per_sm >= 1
    assert math.ceil(1024 / rows_per_cta) <= SMS * ctas_per_sm


def c_parameter_count(source: str, entry: str) -> int:
    signature = re.search(rf"int {entry}\((.*?)\)\s*\{{", source, re.S).group(1)
    return signature.count(",") + 1


@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_argtypes_match_the_c_entry_point(arena):
    source_name, entry, _ = KERNELS[arena]
    library = ti.LIBRARY if arena == "unit" else ti.RLE_LIBRARY
    assert library.entry == entry
    assert len(library.argtypes) == c_parameter_count((CSRC / source_name).read_text(), entry)


class FakeLibrary:
    def __init__(self):
        self.calls = []

    def launch(self, *args):
        self.calls.append(args)


class FakeStream:
    cuda_stream = 0


@pytest.mark.parametrize("arena", ["unit", "rle"])
@pytest.mark.parametrize("width", [64, 4096, 6000])
def test_launch_passes_the_window_and_a_done_scratch_only_when_needed(
    monkeypatch, arena, width
):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    fake = FakeLibrary()
    library = ti.LIBRARY if arena == "unit" else ti.RLE_LIBRARY
    num_docs, num_slots, batch = 5, 3, 7
    if arena == "unit":
        state = tk.make_empty_state(num_docs, width, "cpu")
        monkeypatch.setattr(ti, "LIBRARY", fake)
        launch = ti.integrate_rows_cuda
    else:
        state = tr.make_empty_rle_state(num_docs, width, "cpu")
        monkeypatch.setattr(ti, "RLE_LIBRARY", fake)
        launch = ti.integrate_rle_rows_cuda
    zeros = np.zeros((num_slots, batch), np.int32)
    ops = tk.ops_from_numpy([zeros] * 8, "cpu")
    launch(state, ops, torch.arange(batch, dtype=torch.int32) % num_docs)
    (args,) = fake.calls
    assert len(args) == len(library.argtypes)
    num_fields = len(state)
    assert args[num_fields : num_fields + 2] == (num_docs, width)
    slots_at = num_fields + 2 + 8
    assert args[slots_at : slots_at + 2] == (num_slots, batch)
    window, done, stream = args[slots_at + 3 :]
    assert window == ti._warp_window(width)
    assert (done is None) == (window >= width)
    assert stream == 0
