"""Scratch of the split flash-decode kernels (``csrc/flash_decode.cuh``).

Both decode kernels cut each lane's keys into fixed segments of ``SEG``
keys, write one f32 partial ``(acc[G][D], m[G], l[G])`` per live segment
(a record of ``G * D + 16`` floats: acc, then m at ``G * D``, l at
``G * D + 8``, so every record starts 16-byte aligned),
and the last block of each (lane, kv head) to finish merges them, counted
by a per-(lane, kv head) counter that the kernel leaves at zero. The
wrappers allocate the partials for each launch and share one counter buffer
per device, allocated zeroed on first use and grown when a batch needs
more counters.
"""

from __future__ import annotations

import torch

SEG = 256  # keys per segment: csrc/flash_decode.cuh's SEG

_counters: dict[torch.device, torch.Tensor] = {}


def n_segments(cap: int) -> int:
    """Segments of a layout whose lanes hold at most ``cap`` keys: the
    grid's z extent, whatever the lanes' lengths."""
    return -(-cap // SEG)


def partial_shape(B: int, K: int, G: int, D: int, cap: int) -> tuple:
    """(B, K, n_seg, G * D + 16): per segment acc (G, D), m (G), l (G)."""
    return (B, K, n_segments(cap), G * D + 16)


def scratch(B: int, K: int, G: int, D: int, cap: int,
            device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The launch's partials (uninitialised) and the device's counters
    (at least ``B * K``, zero)."""
    part = torch.empty(partial_shape(B, K, G, D, cap), dtype=torch.float32,
                       device=device)
    cnt = _counters.get(device)
    if cnt is None or cnt.numel() < B * K:
        cnt = torch.zeros(max(B * K, 256), dtype=torch.int32, device=device)
        _counters[device] = cnt
    return part, cnt
