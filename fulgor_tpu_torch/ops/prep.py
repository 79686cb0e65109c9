"""Window prep (kernel K1): per-window k-mer packings and minimizers.

Counterpart of fulgor_tpu/ops/minidict2.py words_from_packed,
_extract_all, _extract_bits_all, _rev2_32 and _window_prep_from_words. For
every k-window p of every read of a host-packed batch (ops/hostpack.py) it
computes, all (B, Wk) with Wk = W - k + 1:

  minval          the window's minimal canonical m-mer hash (mix32 of the
                  canonical big-endian m-mer; 0xFFFFFFFF for an m-mer with
                  an invalid base, 0xFFFFFFFE for a natural 0xFFFFFFFF);
  iL, iR          offsets of its leftmost / rightmost occurrence;
  pL, pR          the same as absolute read positions;
  sigL, sigR      whether the forward m-mer is the canonical one there;
  flo/fhi/rlo/rhi the forward and reverse-complement LSB-first k-mer
                  packings (u32 halves);
  usable          all k bases valid and minval != 0xFFFFFFFF.

u32 outputs are torch.int32 bit patterns; iL/iR/pL/pR int32; flags bool.
`window_prep` launches csrc/prep.cu for CUDA tensors and runs the plain
version `window_prep_plain` for CPU tensors.

Also the array API's packing (kernel K8, counterpart of fulgor_tpu's
_device_pack_codes): `pack_codes` launches csrc/pack.cu for CUDA tensors and
runs `pack_codes_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .minidict import SEED_M
from .u32 import M32, i32, mix32

PREP_FIELDS = ("minval", "iL", "iR", "pL", "pR", "sigL", "sigR",
               "flo", "fhi", "rlo", "rhi", "usable")
MAX_WIDTH = 1024


def _unpack(codes2: torch.Tensor, bad: torch.Tensor, width: int):
    """-> (codes (B, W) int64 0..3, badb (B, W) bool)."""
    B = codes2.shape[0]
    dev = codes2.device
    c = codes2.to(torch.int64)
    codes = ((c[:, :, None] >> torch.arange(0, 8, 2, device=dev)) & 3)
    b = bad.to(torch.int64)
    badb = ((b[:, :, None] >> torch.arange(8, device=dev)) & 1) == 1
    return codes.reshape(B, width), badb.reshape(B, width)


def window_prep_plain(codes2, bad, *, width: int, k: int, m: int):
    """Plain PyTorch window prep (any device): direct per-base packing and
    an explicit sliding minimum, in int64."""
    codes, badb = _unpack(codes2, bad, width)
    B = codes.shape[0]
    dev = codes.device
    Wk, Wm, w = width - k + 1, width - m + 1, k - m + 1
    z = torch.zeros((B, Wk), dtype=torch.int64, device=dev)
    flo, fhi, rlo, rhi = z.clone(), z.clone(), z.clone(), z.clone()
    okw = torch.ones((B, Wk), dtype=torch.bool, device=dev)
    for i in range(k):
        ci = codes[:, i:i + Wk]
        cj = 3 - codes[:, k - 1 - i:k - 1 - i + Wk]
        okw &= ~badb[:, i:i + Wk]
        if 2 * i < 32:
            flo |= ci << (2 * i)
            rlo |= cj << (2 * i)
        else:
            fhi |= ci << (2 * i - 32)
            rhi |= cj << (2 * i - 32)

    # canonical big-endian m-mers (2m <= 62 bits fit int64 directly)
    fwd = torch.zeros((B, Wm), dtype=torch.int64, device=dev)
    rc = torch.zeros_like(fwd)
    ok_m = torch.ones((B, Wm), dtype=torch.bool, device=dev)
    for i in range(m):
        ci = codes[:, i:i + Wm]
        fwd |= ci << (2 * (m - 1 - i))
        rc |= (3 - ci) << (2 * i)
        ok_m &= ~badb[:, i:i + Wm]
    take_f = fwd <= rc
    can = torch.where(take_f, fwd, rc)
    h = mix32((can & M32) ^ mix32((can >> 32) ^ SEED_M))
    h = torch.where(h == M32, M32 - 1, h)
    h = torch.where(ok_m, h, M32)

    # sliding minimum over the w m-mers of each window
    hs = torch.stack([h[:, j:j + Wk] for j in range(w)], dim=2)
    minval = hs.amin(dim=2)
    eq = hs == minval[:, :, None]
    jj = torch.arange(w, device=dev)
    iL = torch.where(eq, jj, w).amin(dim=2)
    iR = torch.where(eq, jj, -1).amax(dim=2)
    kpos = torch.arange(Wk, device=dev)[None, :]
    pL, pR = kpos + iL, kpos + iR
    sigL = torch.gather(take_f, 1, pL)
    sigR = torch.gather(take_f, 1, pR)
    usable = okw & (minval != M32)
    as32 = lambda t: t.to(torch.int32)  # noqa: E731 (small offsets)
    return (i32(minval), as32(iL), as32(iR), as32(pL), as32(pR), sigL, sigR,
            i32(flo), i32(fhi), i32(rlo), i32(rhi), usable)


def window_prep(codes2, bad, *, width: int, k: int, m: int):
    """Window prep of a packed batch: codes2 (B, W/4) uint8, bad (B, W/8)
    uint8 -> the 12 PREP_FIELDS tensors, each (B, W - k + 1)."""
    if codes2.device.type == "cpu":
        return window_prep_plain(codes2, bad, width=width, k=k, m=m)
    if codes2.device.type != "cuda":
        raise ValueError(f"window_prep: unsupported device {codes2.device}")
    B = codes2.shape[0]
    if not (width % 32 == 0 and m <= k <= 32 and m < 32 and k <= width
            and width <= MAX_WIDTH):
        raise ValueError(f"window_prep: unsupported width={width} k={k} m={m}")
    if (codes2.dtype != torch.uint8 or bad.dtype != torch.uint8
            or tuple(codes2.shape) != (B, width // 4)
            or tuple(bad.shape) != (B, width // 8)
            or bad.device != codes2.device):
        raise ValueError("window_prep: codes2/bad must be uint8 (B, W/4) and "
                         "(B, W/8) on one device")
    codes2, bad = codes2.contiguous(), bad.contiguous()
    Wk = width - k + 1
    dev = codes2.device
    outs = []
    for f in PREP_FIELDS:
        dt = torch.bool if f in ("sigL", "sigR", "usable") else torch.int32
        outs.append(torch.empty((B, Wk), dtype=dt, device=dev))
    if B == 0:
        return tuple(outs)
    lib = kernels.library()
    rc = lib.fulgor_window_prep(
        codes2.data_ptr(), bad.data_ptr(), B, width, k, m,
        *(o.data_ptr() for o in outs), kernels.stream_of(codes2))
    kernels.check(rc, "window_prep")
    kernels.launches["window_prep"] += 1
    return tuple(outs)


def pack_codes_plain(codes):
    """Plain PyTorch version of K8 (any device): (B, L) integer codes (0..3
    valid, anything else bad) -> (words (B, ceil(L/16)) int32, 16 bases a
    word LSB-first with bad bases as 0; badw (B, ceil(L/32)) int32, one bit
    a base, set for bad bases and past L), u32 bit patterns."""
    B, L = codes.shape
    dev = codes.device
    c = codes.to(torch.int64)
    bad = (c < 0) | (c > 3)
    c = torch.where(bad, 0, c)
    Lw, Lb = -(-L // 16) * 16, -(-L // 32) * 32
    c = torch.cat([c, c.new_zeros((B, Lw - L))], dim=1)
    words = (c.reshape(B, Lw // 16, 16)
             << (2 * torch.arange(16, device=dev))).sum(dim=2)
    bad = torch.cat([bad, bad.new_ones((B, Lb - L))], dim=1).to(torch.int64)
    badw = (bad.reshape(B, Lb // 32, 32)
            << torch.arange(32, device=dev)).sum(dim=2)
    return i32(words), i32(badw)


def pack_codes(codes):
    """2-bit packing of a (B, L) uint8 code batch on its device -> (words
    (B, ceil(L/16)) int32, badw (B, ceil(L/32)) int32). At L % 32 == 0,
    words.view(torch.uint8) and badw.view(torch.uint8) are the host
    packer's codes2 (B, L/4) and bad (B, L/8)."""
    if codes.device.type == "cpu":
        return pack_codes_plain(codes)
    if codes.device.type != "cuda":
        raise ValueError(f"pack_codes: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("pack_codes: codes must be a (B, L) uint8 tensor")
    B, L = codes.shape
    codes = codes.contiguous()
    words = torch.empty((B, -(-L // 16)), dtype=torch.int32, device=codes.device)
    badw = torch.empty((B, -(-L // 32)), dtype=torch.int32, device=codes.device)
    if B == 0 or L == 0:
        return words, badw
    lib = kernels.library()
    rc = lib.fulgor_pack_codes(codes.data_ptr(), B, L, words.data_ptr(),
                               badw.data_ptr(), kernels.stream_of(codes))
    kernels.check(rc, "pack_codes")
    kernels.launches["pack_codes"] += 1
    return words, badw
