"""What kernel 9's launch depends on, on the CPU: the plain twin of its
key-split path (``ops.split_attention_plain``: partials over key ranges,
then the merge that ``split_kernel`` and ``merge_kernel`` compute), the
planner that picks the path and the split (``ops.plan``), and the
restated tolerance of the kernel (``ref.tolerance``).

The twin is held against the JAX package's
``flash_attention/ref.py::attention`` on numpy inputs made from a seed,
in float32 within 2e-5 (the JAX kernel test's tolerance: the same
softmax, summed in another order).  The tolerance is shown right in
both directions: it admits a plain emulation of the tensor-core path,
which rounds P to bf16 before P V, and rejects a causal mask and a
window each off by one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jax_fa_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from _torch_threads import one_thread  # noqa: F401

TOL = 2e-5

# the JAX kernel test's sweep (Sq, Sk, dh, causal, window, q_offset), and
# a window without causality
SWEEP = [(128, 128, 64, True, None, 0), (64, 64, 32, False, None, 0),
         (128, 256, 64, True, 64, 0), (1, 256, 64, True, None, 255),
         (64, 192, 128, True, None, 128), (96, 100, 64, True, None, 4),
         (17, 40, 16, False, 8, 3)]


def _inputs(rng, b, sq, sk, hq, hkv, dh):
    """numpy float32 (B, S, H, dh) q, k, v."""
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32)
            for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))


def _jax_want(q, k, v, causal, window, q_offset):
    """The JAX ref over the (B * Hq, S, dh) layout, kv heads repeated;
    back in (B, Sq, Hq, dh)."""
    b, sq, hq, dh = q.shape
    rep = hq // k.shape[2]

    def heads(x):
        x = np.repeat(x, rep, axis=2) if x.shape[2] != hq else x
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * hq, -1, dh))
    out = jax_fa_ref.attention(heads(q), heads(k), heads(v), causal=causal,
                               window=window, q_offset=q_offset)
    return np.asarray(out).reshape(b, hq, sq, dh).transpose(0, 2, 1, 3)


def _twin(q, k, v, causal, window, q_offset, n_split):
    return fa_ops.split_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, q_offset=q_offset, n_split=n_split).numpy()


@pytest.mark.parametrize("n_split", [1, 3, 8])
@pytest.mark.parametrize("sq,sk,dh,causal,window,q_off", SWEEP)
def test_split_twin_matches_jax_ref_on_the_sweep(sq, sk, dh, causal, window,
                                                 q_off, n_split):
    rng = np.random.default_rng(sq + sk + dh + n_split)
    q, k, v = _inputs(rng, 3, sq, sk, 1, 1, dh)
    np.testing.assert_allclose(
        _twin(q, k, v, causal, window, q_off, n_split),
        _jax_want(q, k, v, causal, window, q_off), rtol=TOL, atol=TOL)


# (B, Sq, Hq, Hkv, dh, Sk, causal, window, q_offset, n_split)
_GQA = [
    (2, 1, 9, 3, 64, 900, True, None, 899, 22),   # smollm decode step
    (2, 3, 6, 2, 32, 300, True, 20, 297, 8),      # window narrower than a split
    (1, 5, 3, 1, 16, 77, False, 9, 70, 4),        # window without causality
    (2, 4, 6, 2, 16, 64, True, None, 60, 5),      # q_offset > 0, rep 3
    (1, 2, 4, 2, 16, 30, True, 4, 80, 3),         # no key reaches a row
]


@pytest.mark.parametrize("b,sq,hq,hkv,dh,sk,causal,window,q_off,n_split",
                         _GQA)
def test_split_twin_matches_jax_ref_gqa(b, sq, hq, hkv, dh, sk, causal,
                                        window, q_off, n_split):
    rng = np.random.default_rng(b * sq + sk)
    q, k, v = _inputs(rng, b, sq, sk, hq, hkv, dh)
    got = _twin(q, k, v, causal, window, q_off, n_split)
    want = _jax_want(q, k, v, causal, window, q_off)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    lo, hi, span = fa_ops.split_ranges(sq, sk, causal, window, q_off,
                                       n_split)
    if hi - lo == 0:                      # the no-key row gives zeros
        assert not got.any()


def test_split_ranges_cover_the_live_keys_once():
    for sq, sk, causal, window, q_off in [(1, 900, True, None, 899),
                                          (3, 300, True, 20, 297),
                                          (5, 77, False, 9, 70),
                                          (2, 30, True, 4, 80)]:
        for n in (1, 3, 7, 22):
            lo, hi, span = fa_ops.split_ranges(sq, sk, causal, window,
                                               q_off, n)
            keys = [k for s in range(n)
                    for k in range(lo + s * span, min(hi, lo + (s + 1) * span))]
            assert keys == list(range(lo, hi))


def test_plan_at_the_smollm_shapes():
    bf16 = torch.bfloat16
    # decode: 4 rows of 3 kv heads at 22 splits fill two waves of 132 SMs
    path, n = fa_ops.plan(4, 3, 3, 1, 1501, bf16, True, None, 1500)
    assert (path, n) == ("split", 22) and 4 * 3 * n >= fa_ops.TARGET_BLOCKS
    # a short cache keeps >= 32 keys a split
    assert fa_ops.plan(4, 3, 3, 1, 385, bf16, True, None, 384) == \
        ("split", 12)
    # prefill, and prefill_32k: the tensor cores
    assert fa_ops.plan(4, 3, 3, 896, 896, bf16)[0] == "wgmma"
    assert fa_ops.plan(32, 3, 3, 32768, 32768, bf16)[0] == "wgmma"
    # float32 keeps the CUDA-core path at any shape
    assert fa_ops.plan(4, 3, 3, 1, 1501, torch.float32, True, None,
                       1500)[0] == "cuda_cores"
    assert fa_ops.plan(4, 3, 3, 896, 896, torch.float32)[0] == "cuda_cores"


@pytest.mark.parametrize("rep,sq,path", [
    (3, 5, "split"), (3, 6, "wgmma"), (1, 16, "split"), (1, 17, "wgmma"),
    (16, 1, "split"), (32, 1, "wgmma")])
def test_plan_boundary_between_the_paths(rep, sq, path):
    """rep * Sq rows of one kv head: up to SPLIT_MAX_ROWS (16) split."""
    assert fa_ops.plan(2, 2, rep, sq, 4096, torch.bfloat16, True, None,
                       4096 - sq)[0] == path


def test_plan_keeps_a_split_for_no_live_key():
    assert fa_ops.plan(1, 1, 1, 1, 10, torch.bfloat16, True, 4, 200) == \
        ("split", 1)


def _emulate(q, k, v, causal, window, q_offset, shift_causal=0,
             shift_window=0, round_p=False):
    """Plain attention on (BH, S, dh) with the masks moved by the shifts;
    ``round_p`` rounds the unnormalised P to bf16 before P V while l sums
    it unrounded, as the tensor-core path does."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask &= kp <= qp - shift_causal
    if window is not None:
        mask &= qp - kp < window + shift_window
    s = torch.where(mask[None], s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = e.to(torch.bfloat16).float() if round_p else e
    out = torch.einsum("bqk,bkd->bqd", p, v.float()) \
        / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def _ratio(got, q, k, v, causal, window, q_offset):
    """max |got - want| over the bound, with q, k, v as (BH, S, 1, dh)."""
    want = fa_ref.attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset).float()
    bound = fa_ref.tolerance(q[:, :, None], k[:, :, None], v[:, :, None],
                             causal=causal, window=window,
                             q_offset=q_offset)[:, :, 0]
    return float(((got.float() - want).abs() / bound).max())


@pytest.mark.parametrize("sq,sk,dh,causal,window,q_off", SWEEP)
def test_bf16_tolerance_admits_rounded_p_and_rejects_off_by_one_masks(
        sq, sk, dh, causal, window, q_off):
    rng = np.random.default_rng(sq * sk + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, s, dh)).astype(
        np.float32)).to(torch.bfloat16) for s in (sq, sk, sk))
    args = (q, k, v, causal, window, q_off)
    assert _ratio(_emulate(*args, round_p=True), *args) <= 1.0
    wrong = []
    if causal:
        wrong.append(_emulate(*args, shift_causal=1))
    if window is not None:
        wrong += [_emulate(*args, shift_window=-1),
                  _emulate(*args, shift_window=1)]
    for got in wrong:
        assert _ratio(got, *args) > 1.0


def test_float32_tolerance_is_unchanged():
    q = torch.ones(1, 2, 1, 16)
    assert torch.equal(fa_ref.tolerance(q, q, q), torch.full_like(q, 2e-5)
                       + 2e-5 * fa_ref.attention_gqa(q, q, q).abs())
