"""Full intersection of the colour-set bit rows (kernel K3).

Counterpart of fulgor_tpu/ops/intersect.py full_intersection_windows, its
one-hot twin full_intersection_onehot and its runs twin compact_runs ->
full_intersection_runs: all three compute the AND of the dense bit rows of
every positive window of a read, with an unmapped read (no positive
window) all-zero. AND is idempotent, so the kernel skips a window whose
csid equals the last one it ANDed — the in-kernel form of compact_runs,
exact with no run budget and no overflow.

dense (S, C32), csid (B, Wk) int32 bit patterns, hit (B, Wk) bool ->
(B, C32) int32 bit patterns. `fi_and` launches csrc/intersect.cu for CUDA
tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels


def fi_and_plain(dense, hit, csid):
    """Plain PyTorch full intersection (any device): one row gather and AND
    per window."""
    B, Wk = hit.shape
    safe = torch.where(hit, csid.to(torch.int64) & 0xFFFFFFFF, 0)
    out = torch.full((B, dense.shape[1]), -1, dtype=torch.int32,
                     device=dense.device)
    for w in range(Wk):
        out = torch.where(hit[:, w, None], out & dense[safe[:, w]], out)
    return torch.where(hit.any(dim=1)[:, None], out, 0)


def fi_and(dense, hit, csid):
    """AND of the bit rows of each read's positive windows -> (B, C32)."""
    if dense.device.type == "cpu":
        return fi_and_plain(dense, hit, csid)
    if dense.device.type != "cuda":
        raise ValueError(f"fi_and: unsupported device {dense.device}")
    B, Wk = hit.shape
    if (dense.dtype != torch.int32 or csid.dtype != torch.int32
            or hit.dtype != torch.bool or tuple(csid.shape) != (B, Wk)
            or hit.device != dense.device or csid.device != dense.device
            or not (dense.is_contiguous() and hit.is_contiguous()
                    and csid.is_contiguous())):
        raise ValueError("fi_and: dense (S, C32) int32, hit (B, Wk) bool and "
                         "csid (B, Wk) int32, contiguous on one device")
    C32 = dense.shape[1]
    out = torch.empty((B, C32), dtype=torch.int32, device=dense.device)
    if B == 0 or C32 == 0:
        return out.zero_()
    lib = kernels.library()
    rc = lib.fulgor_fi_and(dense.data_ptr(), C32, hit.data_ptr(),
                           csid.data_ptr(), B, Wk, out.data_ptr(),
                           kernels.stream_of(dense))
    kernels.check(rc, "fi_and")
    kernels.launches["fi_and"] += 1
    return out
