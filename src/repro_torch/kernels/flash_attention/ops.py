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
them, and each row's log-sum-exp where the forward saved it (else a
first pass computes it).  ``backward_blocked_plain`` is the plain twin
of its bf16 schedule, for the tests.  ``attention`` is kernel 9 with
that gradient, the ``torch.autograd.Function`` the training path calls;
its forward saves the log-sum-exp (``attention_with_lse``).

``forward_cost`` and ``backward_cost`` are each call's FLOPs and bytes,
which the entries report to an active ``launch/roofline.py`` counter and
from which ``chip_smoke.py`` takes the kernel table's bounds.  On
PyTorch's ``meta`` device an entry allocates its outputs and scratch (9's
saved log-sum-exp, 9b's row buffers) there and launches nothing.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import CudaKernel, stream_handle
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch.roofline import kernel as count_kernel

KERNEL = CudaKernel("flash_attention", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int,
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


def live_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
               q_offset: int) -> Tuple[int, int]:
    """(live (query, key) pairs, keys some query reaches) of one head."""
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(sk, qpos + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, int)
    pairs = int(np.clip(hi - lo, 0, None).sum())
    return pairs, int(max(hi.max() - lo.min(), 0))


def forward_cost(q, k, causal: bool = True, window: Optional[int] = None,
                 q_offset: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one kernel-9 call on these shapes: 4 dh flops a
    live (query, key) pair; q read and the output written once, the keys
    and values that some query's mask reaches read once."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pairs, keys = live_pairs(sq, sk, causal, window, q_offset)
    elt = q.element_size()
    return (4 * dh * pairs * b * hq,
            2 * b * sq * hq * dh * elt + 2 * b * hkv * keys * dh * elt)


def backward_cost(q, k, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one kernel-9b call: 10 dh flops a live pair (S,
    dP, dV, dQ, dK); q, o, dO read and dq written, k, v read and dk, dv
    written, once each."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pairs, _ = live_pairs(sq, sk, causal, window, q_offset)
    elt = q.element_size()
    return (10 * dh * pairs * b * hq,
            4 * b * sq * hq * dh * elt + 4 * b * sk * hkv * dh * elt)


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


def launch(q, k, v, causal: bool, window: Optional[int], q_offset: int,
           lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors in the (B, S, H, dh)
    layout: the (B, Sq, Hq, dh) result, contiguous at the kernel's head
    dims and past 128; at another dh, the slice of the result at
    ``padded_dim(dh)``.  ``lse``, a float32 (B, Hq, Sq) tensor, takes each
    row's base-2 log-sum-exp where ``saves_lse`` (else it is refused)."""
    return at_kernel_width(_launch, q, k, v, causal, window, q_offset, lse)


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
            lse: Optional[torch.Tensor], scale: float) -> torch.Tensor:
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
    if lse is not None and path != "wgmma":
        raise ValueError(f"the {path} path stores no log-sum-exp")
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
    KERNEL.launch_on(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if lse is None else lse.data_ptr(), strides, b, hq,
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
    with count_kernel("flash_attention",
                      lambda: forward_cost(q, k, causal, window, q_offset),
                      q.dtype):
        if all(t.device.type == "cpu" for t in (q, k, v)):
            # contiguous, as the kernel writes it
            return ref.attention_gqa(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset).contiguous()
        padded_dim(q.shape[3])
        KERNEL.ready(q, k, v)
        return launch(q, k, v, causal, window, q_offset)


def saves_lse(q, k, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> bool:
    """Whether kernel 9's launch on these shapes stores each row's
    log-sum-exp: the bf16 prefill path ("wgmma"), at head dims up to 128."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    return dh <= _HEAD_DIMS[-1] and plan(
        b, hkv, hq // hkv, sq, k.shape[1], q.dtype, causal, window,
        q_offset)[0] == "wgmma"


def attention_with_lse(q, k, v, causal: bool = True,
                       window: Optional[int] = None, q_offset: int = 0
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``flash_attention_gqa`` and each row's base-2 log-sum-exp, (B, Hq,
    Sq) float32 (``ref.attention_lse``): for CPU tensors both plain; on
    the card the prefill path's stored by the same launch, None on the
    other paths (kernel 9b then computes it)."""
    _check(q, k, v, window, q_offset)
    with count_kernel("flash_attention",
                      lambda: forward_cost(q, k, causal, window, q_offset),
                      q.dtype):
        if all(t.device.type == "cpu" for t in (q, k, v)):
            return (ref.attention_gqa(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset).contiguous(),
                    ref.attention_lse(q, k, causal=causal, window=window,
                                      q_offset=q_offset))
        padded_dim(q.shape[3])
        KERNEL.ready(q, k, v)
        lse = None
        if saves_lse(q, k, causal, window, q_offset):
            b, sq, hq, _ = q.shape
            lse = torch.empty(b, hq, sq, dtype=torch.float32,
                              device=q.device)
        return launch(q, k, v, causal, window, q_offset, lse), lse


# kernel 9b's two entries, each on 22 values packed as int64 (q, k, v, o,
# dout, dq, dk, dv, lse, delta, rows, B, Sq, Sk, Hq, Hkv, dh, q_offset,
# window, causal, bf16, stream) and the softmax scale: the gradient, and
# the first pass (each row's log-sum-exp and delta) that runs where no
# saved log-sum-exp is given and on float32
KERNEL_BWD = CudaKernel("flash_attention_bwd", [ctypes.c_char_p,
                                                ctypes.c_float])
KERNEL_BWD_LSE = CudaKernel("flash_attention_bwd_lse",
                            [ctypes.c_char_p, ctypes.c_float],
                            stem="flash_attention_bwd")
_BWD_ARGS = struct.Struct("22q")
BWD_MAX_DH = _HEAD_DIMS[-1]
BWD_TILE = 64     # query rows and keys of a bf16 tile (kT)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned start (a copy if not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch_backward(q, k, v, o, do, causal: bool, window: Optional[int],
                    q_offset: int, lse: Optional[torch.Tensor] = None):
    """Kernel 9b on checked CUDA tensors: (dq, dk, dv), at a padded head
    dim sliced back to dh.  bf16 takes ``lse`` where given; float32, or
    bf16 without it, first runs the pass that computes it."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    width = padded_dim(dh)
    bf16 = q.dtype == torch.bfloat16
    xs = [_aligned(x) if width == dh else pad_head_dim(x, width)
          for x in (q, k, v, o, do)]
    grads = [torch.empty_like(x) for x in xs[:3]]
    rows = delta = None
    if bf16:
        n_qt = -(-sq // BWD_TILE)
        rows = torch.empty(b * hq * n_qt * 2 * BWD_TILE, dtype=torch.float32,
                           device=q.device)

    def pack(lse_ptr):
        return _BWD_ARGS.pack(
            *(x.data_ptr() for x in xs), *(g.data_ptr() for g in grads),
            lse_ptr, 0 if delta is None else delta.data_ptr(),
            0 if rows is None else rows.data_ptr(), b, sq, sk, hq, hkv,
            width, q_offset, 0 if window is None else window, int(causal),
            int(bf16), stream_handle(q.device))
    if lse is None or not bf16:
        lse = torch.empty(b * hq * sq, dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse)
        KERNEL_BWD_LSE.launch_on(q.device, pack(lse.data_ptr()), dh ** -0.5)
    KERNEL_BWD.launch_on(q.device, pack(lse.data_ptr()), dh ** -0.5)
    return tuple(g if width == dh else g[..., :dh] for g in grads)


def flash_attention_gqa_backward(q, k, v, o, do, causal: bool = True,
                                 window: Optional[int] = None,
                                 q_offset: int = 0,
                                 lse: Optional[torch.Tensor] = None):
    """The gradient of ``flash_attention_gqa(q, k, v, ...)``, whose output
    was ``o``, given its gradient ``do``: (dq, dk, dv) in q's dtype.
    ``lse``: each row's log-sum-exp (B, Hq, Sq) float32, as
    ``attention_with_lse`` gives it, or None.  CPU tensors take the plain
    version, at any head dim; CUDA tensors launch kernel 9b, at head dims
    up to BWD_MAX_DH (float32 computes the log-sum-exp itself)."""
    _check(q, k, v, window, q_offset)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)} "
                         f"and dtype {q.dtype}, got {o.dtype} "
                         f"{tuple(o.shape)} and {do.dtype} "
                         f"{tuple(do.shape)}")
    b, sq, hq, dh = q.shape
    if lse is not None and (lse.shape != (b, hq, sq)
                            or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 "
                         f"{(b, hq, sq)} tensor, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    ts = (q, k, v, o, do) + (() if lse is None else (lse,))
    with count_kernel("flash_attention_bwd",
                      lambda: backward_cost(q, k, causal, window, q_offset),
                      q.dtype):
        if all(t.device.type == "cpu" for t in ts):
            return tuple(g.contiguous() for g in ref.attention_gqa_backward(
                q, k, v, o, do, causal=causal, window=window,
                q_offset=q_offset, lse=lse))
        if dh > BWD_MAX_DH:
            raise ValueError(f"head dim {dh} > {BWD_MAX_DH}: kernel 9b "
                             f"takes head dims up to {BWD_MAX_DH}")
        KERNEL_BWD.ready(*ts)
        return launch_backward(q, k, v, o, do, causal, window, q_offset,
                               lse)


def _live_queries(k0: int, tile: int, sq: int, sk: int, causal: bool,
                  window: Optional[int], q_offset: int) -> range:
    """The query tiles (their first rows) that reach a key of the tile at
    k0, as ``dkdv_wgmma`` walks them."""
    lo = max(0, k0 - q_offset) if causal else 0
    hi = sq
    if window:
        hi = min(hi, min(k0 + tile, sk) - 1 + window - q_offset)
    return range(lo // tile * tile, hi, tile)


def _live_key_tiles(q0: int, tile: int, sq: int, sk: int, causal: bool,
                    window: Optional[int], q_offset: int) -> range:
    """The key tiles (their first keys) that rows q0 .. q0 + tile - 1
    reach, as ``dq_wgmma`` walks them."""
    last = min(q0 + tile, sq) - 1 + q_offset
    hi = min(sk, last + 1) if causal else sk
    lo = max(0, q0 + q_offset - window + 1) if window else 0
    return range(lo // tile * tile, hi, tile)


def backward_blocked_plain(q, k, v, o, do, causal: bool = True,
                           window: Optional[int] = None, q_offset: int = 0,
                           lse: Optional[torch.Tensor] = None,
                           tile: int = BWD_TILE,
                           rounding: Optional[torch.dtype] = torch.bfloat16):
    """The plain twin of kernel 9b's bf16 path, in float32, with ``tile``
    rows a tile: delta and the log-sum-exp a row (``rows_kernel``; the
    lse ``ref.attention_lse``'s where not given); then ``dkdv_wgmma``'s
    schedule (a key tile at a time, the live query tiles of its rep query
    heads in order, head then tile) and ``dq_wgmma``'s (a query tile, its
    live key tiles).  P = exp2(log2(e) scale S - lse), masked element by
    element only on tiles not wholly inside the masks; dS = P (dP -
    delta); P and dS rounded to ``rounding`` (the kernel's bf16, or None)
    before the products, the sums in float32.  Rows and keys past Sq and
    Sk are zero, lse +inf.  -> (dq, dk, dv) in q's dtype."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = dh ** -0.5
    c2 = scale * ref.LOG2E
    nq, nk = -(-sq // tile) * tile, -(-sk // tile) * tile
    F = torch.nn.functional

    def rows(x, n):     # (B, S, H, dh) zero-padded to n rows
        return F.pad(x.float(), (0, 0, 0, 0, 0, n - x.shape[1]))
    qf, dof, of = rows(q, nq), rows(do, nq), rows(o, nq)
    kf, vf = rows(k, nk), rows(v, nk)
    if lse is None:
        lse = ref.attention_lse(q, k, causal=causal, window=window,
                                q_offset=q_offset)
    lse = F.pad(lse.float(), (0, nq - sq), value=float("inf"))
    delta = (dof * of).sum(-1).transpose(1, 2)           # (B, Hq, nq)

    def rnd(x):
        return x if rounding is None else x.to(rounding).float()

    def p_ds(h, q0, k0):
        """P and dS (B, tile, tile) of query head h's rows q0.. and keys
        k0.."""
        qs, ks = slice(q0, q0 + tile), slice(k0, k0 + tile)
        s = torch.einsum("bqd,bkd->bqk", qf[:, qs, h], kf[:, ks, h // rep])
        qi = q0 + torch.arange(tile)[:, None]
        kj = k0 + torch.arange(tile)[None, :]
        inside = q0 + tile <= sq and k0 + tile <= sk \
            and (not causal or k0 + tile - 1 <= q0 + q_offset) \
            and (not window or q0 + tile - 1 + q_offset - k0 < window)
        if not inside:
            live = (qi < sq) & (kj < sk)
            if causal:
                live &= kj <= qi + q_offset
            if window:
                live &= qi + q_offset - kj < window
            s = torch.where(live, s, float("-inf"))
        p = torch.exp2(s * c2 - lse[:, h, qs, None])
        dp = torch.einsum("bqd,bkd->bqk", dof[:, qs, h], vf[:, ks, h // rep])
        return p, p * (dp - delta[:, h, qs, None])

    dq = torch.zeros(b, nq, hq, dh)
    dk = torch.zeros(b, nk, hkv, dh)
    dv = torch.zeros(b, nk, hkv, dh)
    for hk in range(hkv):
        for k0 in range(0, sk, tile):
            ks = slice(k0, k0 + tile)
            for h in range(hk * rep, (hk + 1) * rep):
                for q0 in _live_queries(k0, tile, sq, sk, causal, window,
                                        q_offset):
                    qs = slice(q0, q0 + tile)
                    p, ds = p_ds(h, q0, k0)
                    dv[:, ks, hk] += torch.einsum("bqk,bqd->bkd", rnd(p),
                                                  dof[:, qs, h])
                    dk[:, ks, hk] += torch.einsum("bqk,bqd->bkd", rnd(ds),
                                                  qf[:, qs, h])
    for h in range(hq):
        for q0 in range(0, sq, tile):
            qs = slice(q0, q0 + tile)
            for k0 in _live_key_tiles(q0, tile, sq, sk, causal, window,
                                      q_offset):
                _, ds = p_ds(h, q0, k0)
                dq[:, qs, h] += torch.einsum("bqk,bkd->bqd", rnd(ds),
                                             kf[:, k0:k0 + tile, h // rep])
    return ((dq[:, :sq] * scale).to(q.dtype), (dk[:, :sk] * scale).to(k.dtype),
            dv[:, :sk].to(v.dtype))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = attention_with_lse(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_gqa_backward(q, k, v, o, do,
                                                  *ctx.masks, lse=lse)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """``flash_attention_gqa`` (kernel 9) with its gradient by kernel 9b
    (the plain versions for CPU tensors), from the log-sum-exp the
    forward saved."""
    return _Attention.apply(q, k, v, causal, window, q_offset)
