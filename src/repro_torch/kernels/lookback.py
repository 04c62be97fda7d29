"""Host scratch of the single-pass decoupled look-back.

The look-back (``csrc/lorenzo_common.cuh``) lets the CTAs of one launch
find the exclusive prefix of a per-tile count without a second pass.
Each launch needs a tile counter, which every launch leaves at 0, and
one 64-bit state word per tile and look-back, tagged with the call's
epoch so that words of earlier calls read as invalid and the array never
needs clearing.  The entropy kernels (``kernels/entropy.py``) and the
Lorenzo ``quantize_pack`` and ``unpack_dequantize{,_reduce}`` run one
look-back per call, the Lorenzo ring hop (``kernels/lorenzo.py``
``unpack_reduce_repack``) two.  All of them take their scratch here, one
per (device, CUDA stream).  The look-back takes the place of the running
word offset that the Pallas kernels carry in SMEM over their sequential
grid; it costs one 8-byte state word per 32 blocks where a scan launch
read every width again, since bytes bound these kernels.
"""
from __future__ import annotations

import threading

import torch

from . import build

__all__ = ["TILE_BLOCKS", "tiles_for", "scratch"]

TILE_BLOCKS = 32  # Lorenzo blocks per look-back tile (csrc/entropy.cu, csrc/lorenzo.cu)
_EPOCHS = 1 << 30  # epochs 1 .. 2**30 - 1 fit the state word's 30 tag bits
_SCRATCH: dict = {}  # (device, stream handle) -> [int64 scratch, last epoch]
_LOCK = threading.Lock()


def tiles_for(nb: int) -> int:
    """Look-back tiles of a launch over ``nb`` Lorenzo blocks."""
    return -(-nb // TILE_BLOCKS)


def scratch(device, state_words: int):
    """Look-back scratch for one call on ``device``'s current stream: (int64
    scratch, epoch).  Element 0 holds the tile counter; then at least
    ``state_words`` state words.  The ranks of a ``ThreadGroup`` share the
    stream, so their calls run in order and take turns on one scratch;
    each gets its own epoch.  A grown scratch starts zeroed (epoch 0, never
    handed out), and the epoch's wrap clears it.  The caller holds the
    scratch until its launch is queued."""
    # by device too: every device's default stream has the handle 0
    key = (device.index, build.stream_handle())
    with _LOCK:
        entry = _SCRATCH.get(key)
        if entry is None or entry[0].numel() - 1 < state_words:
            size = max(state_words, 2 * (entry[0].numel() - 1) if entry else 0)
            entry = _SCRATCH[key] = [
                torch.zeros(size + 1, dtype=torch.int64, device=device), 0]
        entry[1] += 1
        if entry[1] == _EPOCHS:
            entry[0].zero_()
            entry[1] = 1
        return entry[0], entry[1]
