"""Blocked online-softmax attention (kernel 9): the wrapper of the CUDA
kernels ``csrc/flash_attention.cu``; its plain PyTorch version is
``kernels/flash_attention/ref.py``.

``flash_attention_gqa`` takes the model's (B, S, H, dh) layout with
fewer kv heads than query heads, and strided views (a slice of the KV
cache) as they are; the Pallas kernel's (BH, S, dh) layout is the case
of one head, ``x[:, :, None]``.  The Pallas tiling arguments (``bq``,
``bk``, ``interpret``) have no counterpart: ``plan`` picks the path and
its split from the shapes.

At head dims up to 128 one call launches one of three paths (``plan``):
bf16 prefill on the tensor cores, bf16 decode with the keys split over
blocks and a merge (``split_attention_plain`` is its plain twin, for the
tests), and float32 on the CUDA cores.  These are built for head dims
16, 32, 64 and 128.  Any other dh up to 128 runs at the next of those
widths (``padded_dim``): q, k and v are zero-padded in the head dim,
which adds nothing to Q K^T and gives zero output columns, the softmax
scale stays dh^-0.5 of the real dh, and the result is sliced back to dh.

Past 128, up to ``WIDE_MAX_DH``, the head dim is the "wide" kernel's
runtime argument (float32 or bf16 alike, tiles from ``wide_tiles``); the
route is chosen by dh alone.  The plain version takes any dh.

``flash_attention_gqa_backward`` is the gradient (dq, dk, dv), the
wrapper of kernel 9b (``csrc/flash_attention_bwd.cu``), whose plain
version is ``ref.attention_gqa_backward``; it takes head dims up to
``BWD_MAX_DH``, others than 16/32/64/128 zero-padded as the forward pads
them.  ``attention`` is kernel 9 with that gradient, the
``torch.autograd.Function`` the training path calls.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.flash_attention import ref

KERNEL = CudaKernel("flash_attention", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128)
_GROUPS = 64          # query-row groups of a float32 block (kGroups)
SPLIT_MAX_ROWS = 16   # rep * Sq of a key-split block (kSplitRows)
MIN_SPLIT_KEYS = 32   # the fewest keys a split takes
TARGET_BLOCKS = 264   # two waves of the H100's 132 SMs
PATHS = {"cuda_cores": 0, "wgmma": 1, "split": 2, "wide": 3}
WIDE_THREADS = 256        # threads of a wide block (kWideThreads)
WIDE_SMEM_MAX = 232448    # shared memory a block may have (kWideSmemMax)
WIDE_SMEM_TWO = 115712    # the most at which two blocks share an SM
WIDE_MAX_ROWS = 16        # query rows of a wide block's tile
WIDE_KEYS = (64, 32, 16, 8)  # the key tiles a wide block may take


def wide_smem(dh: int, bq: int, bk: int) -> int:
    """Shared-memory bytes of a wide block (``wide_smem`` in the source):
    the scaled q tile and the accumulator (bq rows), the K and V tiles
    (bk rows), in float32 rows of dh rounded up to 32 plus 4; P; and m,
    l and the correction of each row."""
    ld = -(-dh // 32) * 32 + 4
    return 4 * (ld * (2 * bq + 2 * bk) + bq * bk + 3 * bq)


def wide_tiles(dh: int, sq: int) -> Tuple[int, int]:
    """(bq, bk) of the wide kernel: the power of two at or above Sq, at
    most WIDE_MAX_ROWS query rows; the widest key tile of WIDE_KEYS at
    which two blocks share an SM, else the widest that fits a block."""
    bq = 1
    while bq < min(sq, WIDE_MAX_ROWS):
        bq *= 2
    for limit in (WIDE_SMEM_TWO, WIDE_SMEM_MAX):
        for bk in WIDE_KEYS:
            if wide_smem(dh, bq, bk) <= limit:
                return bq, bk
    raise ValueError(f"head dim {dh} > {WIDE_MAX_DH}: the CUDA kernel's "
                     f"tiles do not fit a block's shared memory")


# the widest head dim at the widest query tile and the narrowest key tile
WIDE_MAX_DH = max(dh for dh in range(_HEAD_DIMS[-1], 4096)
                  if wide_smem(dh, WIDE_MAX_ROWS, WIDE_KEYS[-1])
                  <= WIDE_SMEM_MAX)


def _check(q, k, v, window, q_offset):
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh)."""
    b, sq, hq, dh = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh \
            or k.shape[1] < 1 or hq % k.shape[2]:
        raise ValueError(f"k and v must be (B, Sk >= 1, Hkv, dh) with Hkv "
                         f"dividing Hq, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh < 1:
        raise ValueError(f"head dim must be >= 1, got {dh}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def padded_dim(dh: int) -> int:
    """The head dim the kernel runs a head dim of ``dh`` at: the least of
    16, 32, 64, 128 at or above it; past 128, dh itself (the wide
    kernel), up to WIDE_MAX_DH."""
    for width in _HEAD_DIMS:
        if dh <= width:
            return width
    if dh <= WIDE_MAX_DH:
        return dh
    raise ValueError(f"head dim {dh} > {WIDE_MAX_DH}: the CUDA kernel "
                     f"takes head dims up to {WIDE_MAX_DH}, what a "
                     f"block's shared memory holds")


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` (B, S, H, dh) zero-padded to (B, S, H, width): a fresh
    contiguous tensor, whose rows are 16-byte aligned."""
    return torch.nn.functional.pad(x, (0, width - x.shape[3]))


def _check_aligned(path: str, q, k, v) -> None:
    """The bf16 paths read 16-byte rows: TMA boxes (prefill; every stride
    of a dim longer than 1 a multiple of 16 bytes) or 16-byte loads of K
    and V rows (split)."""
    views = (q, k, v) if path == "wgmma" else (k, v)
    for x in views:
        bad = x.data_ptr() % 16 or any(
            x.stride(i) * x.element_size() % 16 for i in range(3)
            if x.shape[i] > 1)
        if bad:
            raise ValueError(f"the {path} path needs 16-byte aligned rows "
                             f"and strides, got strides {x.stride()} at "
                             f"address {x.data_ptr():#x}")


def query_tile(sq: int) -> int:
    """Rows of the float32 block's query tile: 64, or the power of two at
    or above Sq for short queries (whose keys the groups then split)."""
    bq = 1
    while bq < min(sq, _GROUPS):
        bq *= 2
    return bq


def live_keys(sq: int, sk: int, causal: bool, window: Optional[int],
              q_offset: int) -> Tuple[int, int]:
    """[lo, hi): the keys some query row's mask reaches."""
    hi = min(sk, q_offset + sq) if causal else sk
    lo = max(0, q_offset - window + 1) if window else 0
    return lo, max(lo, hi)


def plan(b: int, hkv: int, rep: int, sq: int, sk: int, dtype,
         causal: bool = True, window: Optional[int] = None,
         q_offset: int = 0) -> Tuple[str, int]:
    """(path, n_split): float32 -> "cuda_cores"; bf16 with more than
    SPLIT_MAX_ROWS rows a kv head (rep * Sq) -> "wgmma"; else "split",
    into n_split ranges of the live keys, enough for B * Hkv * n_split >=
    TARGET_BLOCKS while each keeps MIN_SPLIT_KEYS keys."""
    if dtype == torch.float32:
        return "cuda_cores", 1
    if rep * sq > SPLIT_MAX_ROWS:
        return "wgmma", 1
    lo, hi = live_keys(sq, sk, causal, window, q_offset)
    want = -(-TARGET_BLOCKS // (b * hkv))
    return "split", max(1, min(want, (hi - lo) // MIN_SPLIT_KEYS))


def split_ranges(sq: int, sk: int, causal: bool, window: Optional[int],
                 q_offset: int, n_split: int) -> Tuple[int, int, int]:
    """(lo, hi, span): split s takes keys [lo + s span, lo + (s+1) span)
    cut at hi."""
    lo, hi = live_keys(sq, sk, causal, window, q_offset)
    return lo, hi, -(-(hi - lo) // n_split)


def split_attention_plain(q, k, v, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          n_split: int = 1) -> torch.Tensor:
    """The plain twin of the split path, in float32: per split, the
    partials (m, l, acc) of each (batch, query head, row) over its key
    range, then their merge, as ``split_kernel`` and ``merge_kernel`` do;
    a split with no live key carries m = -inf and weight 0."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    lo, hi, span = split_ranges(sq, sk, causal, window, q_offset, n_split)
    qf = q.float().transpose(1, 2) * dh ** -0.5            # (B, Hq, Sq, dh)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    ms, ls, accs = [], [], []
    for s in range(n_split):
        a, e = lo + s * span, min(hi, lo + (s + 1) * span)
        kpos = torch.arange(a, max(a, e), device=q.device)[None, :]
        mask = kpos < e
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (qpos - kpos < window)
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, a:max(a, e)])
        sc = torch.where(mask, sc, float("-inf"))
        m = sc.amax(-1) if sc.shape[-1] else torch.full(
            sc.shape[:-1], float("-inf"), device=q.device)
        p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, a:max(a, e)]))
    m = torch.stack(ms)
    mx = m.amax(0)
    f = torch.exp(m - torch.where(torch.isfinite(mx), mx, 0.0))
    lsum = (torch.stack(ls) * f).sum(0)
    asum = (torch.stack(accs) * f[..., None]).sum(0)
    out = torch.where(lsum[..., None] > 0,
                      asum / lsum.clamp(min=1e-30)[..., None], 0.0)
    return out.transpose(1, 2).to(q.dtype)


def launch(q, k, v, causal: bool, window: Optional[int],
           q_offset: int) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors in the (B, S, H, dh)
    layout: the (B, Sq, Hq, dh) result, contiguous at the kernel's head
    dims and past 128; at another dh, the slice of the result at
    ``padded_dim(dh)``."""
    return at_kernel_width(_launch, q, k, v, causal, window, q_offset)


def at_kernel_width(fn, q, k, v, *args) -> torch.Tensor:
    """``fn(q, k, v, *args, scale)`` at the kernel's head dim: with q, k
    and v zero-padded to ``padded_dim(dh)`` where dh is not one of its
    widths, ``scale`` dh^-0.5 of the real dh, and the result sliced back
    to dh."""
    dh = q.shape[3]
    width = padded_dim(dh)
    if width == dh:
        return fn(q, k, v, *args, dh ** -0.5)
    out = fn(*(pad_head_dim(x, width) for x in (q, k, v)), *args, dh ** -0.5)
    return out[..., :dh]


def _launch(q, k, v, causal: bool, window: Optional[int], q_offset: int,
            scale: float) -> torch.Tensor:
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    bq, bk = query_tile(sq), 0
    if dh > _HEAD_DIMS[-1]:
        path, n_split = "wide", 1
        bq, bk = wide_tiles(dh, sq)
    else:
        path, n_split = plan(b, hkv, rep, sq, sk, q.dtype, causal, window,
                             q_offset)
    lo = hi = span = 0
    part = None
    if path in ("wgmma", "split"):
        _check_aligned(path, q, k, v)
    if path == "split":
        lo, hi, span = split_ranges(sq, sk, causal, window, q_offset,
                                    n_split)
        part = torch.empty(b * hkv * n_split * rep * sq * (dh + 2),
                           dtype=torch.float32, device=q.device)
    out = torch.empty(b, sq, hq, dh, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *[x.stride(i) for x in (q, k, v, out) for i in (0, 2, 1)])
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(), strides, b, hq,
                  rep, sq, sk, dh, q_offset, 0 if window is None else window,
                  int(causal), PATHS[path], bq, n_split, lo, hi, span,
                  int(q.dtype == torch.bfloat16), bk, scale,
                  stream_handle(q.device))
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, dh) over k, v (B, Sk, Hkv, dh), query
    head h reading kv head h // (Hq // Hkv), query row i at absolute
    position ``q_offset + i``; -> (B, Sq, Hq, dh) in q's dtype.  CPU
    tensors take the plain version, at any head dim; CUDA tensors launch
    the kernel, at head dims up to WIDE_MAX_DH (``padded_dim``)."""
    _check(q, k, v, window, q_offset)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention_gqa(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    padded_dim(q.shape[3])
    KERNEL.load()
    require_cuda(q, k, v)
    return launch(q, k, v, causal, window, q_offset)


# kernel 9b's entry: 21 values packed as int64 (q, k, v, o, dout, dq, dk,
# dv, lse, delta, B, Sq, Sk, Hq, Hkv, dh, q_offset, window, causal, bf16,
# stream) and the softmax scale
KERNEL_BWD = CudaKernel("flash_attention_bwd", [ctypes.c_char_p,
                                                ctypes.c_float])
_BWD_ARGS = struct.Struct("21q")
BWD_MAX_DH = _HEAD_DIMS[-1]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned start (a copy if not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch_backward(q, k, v, o, do, causal: bool, window: Optional[int],
                    q_offset: int):
    """Kernel 9b on checked CUDA tensors: (dq, dk, dv), at a padded head
    dim sliced back to dh."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    width = padded_dim(dh)
    xs = [_aligned(x) if width == dh else pad_head_dim(x, width)
          for x in (q, k, v, o, do)]
    grads = [torch.empty_like(x) for x in xs[:3]]
    lse = torch.empty(b * hq * sq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    KERNEL_BWD.launch(_BWD_ARGS.pack(
        *(x.data_ptr() for x in xs), *(g.data_ptr() for g in grads),
        lse.data_ptr(), delta.data_ptr(), b, sq, sk, hq, hkv, width,
        q_offset, 0 if window is None else window, int(causal),
        int(q.dtype == torch.bfloat16), stream_handle(q.device)),
        dh ** -0.5)
    return tuple(g if width == dh else g[..., :dh] for g in grads)


def flash_attention_gqa_backward(q, k, v, o, do, causal: bool = True,
                                 window: Optional[int] = None,
                                 q_offset: int = 0):
    """The gradient of ``flash_attention_gqa(q, k, v, ...)``, whose output
    was ``o``, given its gradient ``do``: (dq, dk, dv) in q's dtype.  CPU
    tensors take the plain version, at any head dim; CUDA tensors launch
    kernel 9b, at head dims up to BWD_MAX_DH."""
    _check(q, k, v, window, q_offset)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)} "
                         f"and dtype {q.dtype}, got {o.dtype} "
                         f"{tuple(o.shape)} and {do.dtype} "
                         f"{tuple(do.shape)}")
    if all(t.device.type == "cpu" for t in (q, k, v, o, do)):
        return ref.attention_gqa_backward(q, k, v, o, do, causal=causal,
                                          window=window, q_offset=q_offset)
    if q.shape[3] > BWD_MAX_DH:
        raise ValueError(f"head dim {q.shape[3]} > {BWD_MAX_DH}: kernel 9b "
                         f"takes head dims up to {BWD_MAX_DH}")
    KERNEL_BWD.load()
    require_cuda(q, k, v, o, do)
    return launch_backward(q, k, v, o, do, causal, window, q_offset)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o = flash_attention_gqa(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o)
        ctx.masks = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_gqa_backward(q, k, v, o, do,
                                                  *ctx.masks)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """``flash_attention_gqa`` (kernel 9) with its gradient by kernel 9b
    (the plain versions for CPU tensors)."""
    return _Attention.apply(q, k, v, causal, window, q_offset)
