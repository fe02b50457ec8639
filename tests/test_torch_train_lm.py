"""LM training on the CPU against the JAX package: ``lm_loss`` and every
parameter's gradient against ``jax.value_and_grad(tf.lm_loss)`` on a
reduced smollm-135m (2 layers, d 64, 4/2 heads of 16, vocab 512, seq 64,
``seq_chunk`` 32), the remat policies, one AdamW step, and the plain
attention backward (kernel 9b's plain version) against autograd and
against ``jax.grad`` of the JAX package's ``chunked_attention``.

Tolerances: float32 rtol 1e-4, atol 1e-6 (the same float32 math in
another summation order; measured gaps are about 1.5e-7 on gradients of
size 0.1).  bfloat16: the two frameworks round to bf16 at different
places (after each matmul, norm and activation), so each gradient is
held to a max gap of 5% and a mean gap of 0.6% of its largest element
(measured: 2.2% and 0.3% at most), the loss to 1e-3 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.models.common import ShardCtx
from repro.models.common import chunked_attention as r_chunked_attention
from repro.optim.adamw import AdamW as RAdamW
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW
from _torch_threads import one_thread  # noqa: F401

_SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=512, d_head=16)


def _setup(dtype):
    kw = dict(_SMALL, dtype=dtype)
    rcfg = r_reduced(r_get_config("smollm-135m"), **kw)
    cfg = reduced(get_config("smollm-135m"), **kw)
    p = r_tf.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 64)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 64)).astype(np.int32)
    loss, grads = jax.value_and_grad(lambda q: r_tf.lm_loss(
        q, toks, labels, rcfg, ShardCtx(mesh=None), seq_chunk=32))(p)
    pt = tf.params_from_jax(cfg, {k: np.asarray(v) for k, v in p.items()},
                            device="cpu")
    return cfg, p, pt, toks, labels, loss, grads


def _port_grads(cfg, pt, toks, labels, **kw):
    pp = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    loss = tf.lm_loss(pp, torch.from_numpy(toks), torch.from_numpy(labels),
                      cfg, seq_chunk=32, **kw)
    grads = torch.autograd.grad(loss, list(pp.values()))
    return loss.detach(), dict(zip(pp, grads))


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


def test_lm_loss_and_grads_match_reference_float32(f32):
    cfg, _, pt, toks, labels, rloss, rgrads = f32
    loss, grads = _port_grads(cfg, pt, toks, labels)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-6)
    assert sorted(grads) == sorted(rgrads)
    for k, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == rgrads[k].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(rgrads[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_lm_loss_and_grads_bf16_within_stated_gap():
    cfg, _, pt, toks, labels, rloss, rgrads = _setup("bfloat16")
    loss, grads = _port_grads(cfg, pt, toks, labels)
    assert abs(float(loss) - float(rloss)) <= 1e-3 * abs(float(rloss))
    for k, g in grads.items():
        assert g.dtype == pt[k].dtype
        want = np.asarray(rgrads[k]).astype(np.float32)
        gap = np.abs(g.float().numpy() - want) / np.abs(want).max()
        assert gap.max() <= 0.05 and gap.mean() <= 0.006, (k, gap.max(),
                                                           gap.mean())


def test_lm_loss_bf16_logits_match_reference():
    """``loss_bf16`` (bf16 logit operands, float32 output) in both
    packages, held to the bf16 gaps above; and against the port's
    default float32 logits, which form the same products (exact in
    float32) in another summation order."""
    kw = dict(_SMALL, dtype="bfloat16", loss_bf16=True)
    rcfg = r_reduced(r_get_config("smollm-135m"), **kw)
    cfg = reduced(get_config("smollm-135m"), **kw)
    p = r_tf.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 64)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 64)).astype(np.int32)
    rloss, rgrads = jax.value_and_grad(lambda q: r_tf.lm_loss(
        q, toks, labels, rcfg, ShardCtx(mesh=None), seq_chunk=32))(p)
    pt = tf.params_from_jax(cfg, {k: np.asarray(v) for k, v in p.items()},
                            device="cpu")
    loss, grads = _port_grads(cfg, pt, toks, labels)
    assert abs(float(loss) - float(rloss)) <= 1e-3 * abs(float(rloss))
    for k, g in grads.items():
        assert g.dtype == pt[k].dtype
        want = np.asarray(rgrads[k]).astype(np.float32)
        gap = np.abs(g.float().numpy() - want) / np.abs(want).max()
        assert gap.max() <= 0.05 and gap.mean() <= 0.006, (k, gap.max(),
                                                           gap.mean())
    dloss, dgrads = _port_grads(reduced(cfg, loss_bf16=False), pt, toks,
                                labels)
    np.testing.assert_allclose(float(loss), float(dloss), rtol=1e-6)
    for k, g in grads.items():
        gap = (g.float() - dgrads[k].float()).abs().max()
        assert gap <= 2 ** -7 * dgrads[k].float().abs().max(), (k, gap)


def test_lm_loss_uneven_chunks_raise_as_reference(f32):
    """S 50 with seq_chunk 16 gives 3 chunks that do not divide it: the
    JAX package's reshape refuses it, and so does the port (no position
    is dropped from the loss)."""
    cfg, p, pt, _, _, _, _ = f32
    rcfg = r_reduced(r_get_config("smollm-135m"), **dict(_SMALL,
                                                         dtype="float32"))
    toks = np.zeros((2, 50), np.int32)
    with pytest.raises(TypeError, match="reshape"):
        r_tf.lm_loss(p, toks, toks, rcfg, ShardCtx(mesh=None), seq_chunk=16)
    t = torch.from_numpy(toks)
    with pytest.raises(ValueError, match="3 equal chunks"):
        tf.lm_loss(pt, t, t, cfg, seq_chunk=16)
    # an S that the chunk count divides still runs: 48 = 3 x 16
    assert torch.isfinite(tf.lm_loss(pt, t[:, :48], t[:, :48], cfg,
                                     seq_chunk=16))


def test_remat_policies_give_the_same_gradients(f32):
    cfg, _, pt, toks, labels, _, _ = f32
    runs = {pol: _port_grads(reduced(cfg, remat_policy=pol), pt, toks,
                             labels)
            for pol in tf.REMAT_POLICIES}
    base_loss, base = runs["none"]
    for pol, (loss, grads) in runs.items():
        assert torch.equal(loss, base_loss), pol
        for k in base:
            assert torch.equal(grads[k], base[k]), (pol, k)
    # remat=False ignores the policy
    loss, grads = _port_grads(reduced(cfg, remat_policy="full"), pt, toks,
                              labels, remat=False)
    assert all(torch.equal(grads[k], base[k]) for k in base)
    with pytest.raises(ValueError, match="remat_policy"):
        _port_grads(reduced(cfg, remat_policy="some"), pt, toks, labels)


def test_one_adamw_step_equals_reference(f32):
    """The launcher's optimizer on the model's parameters and the JAX
    package's gradients, in both packages (the same inputs: Adam's first
    step is about g / |g|, so a gradient within float32 rounding of zero
    may take either sign, and the gradients themselves are held above)."""
    cfg, p, pt, toks, labels, _, rgrads = f32
    grads = {k: torch.from_numpy(np.asarray(g)) for k, g in rgrads.items()}
    ropt, opt = RAdamW(lr=1e-3, total_steps=20), AdamW(lr=1e-3,
                                                       total_steps=20)
    rp, rst = ropt.update(rgrads, ropt.init(p), p)
    tp, st = opt.update(grads, opt.init(pt), pt)
    assert int(st.step) == 1
    for k in rp:
        for got, want in ((tp[k], rp[k]), (st.mu[k], rst.mu[k]),
                          (st.nu[k], rst.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def test_moe_configs_still_raise():
    """MoE configs no longer raise: qwen3-moe-30b-a3b at these dims with
    the launchers' MoE cut (4 experts, top-2, d_ff_expert 32), its
    ``lm_loss`` and every gradient (the router's and the experts') against
    ``jax.value_and_grad`` of the JAX package's, in float32."""
    from repro.configs.base import MoEConfig as RMoE
    from repro_torch.configs.base import MoEConfig
    moe = dict(n_experts=4, top_k=2, d_ff_expert=32)
    kw = dict(_SMALL, dtype="float32")
    rcfg = r_reduced(r_get_config("qwen3-moe-30b-a3b"), **kw,
                     moe=RMoE(**moe))
    cfg = reduced(get_config("qwen3-moe-30b-a3b"), **kw,
                  moe=MoEConfig(**moe))
    p = r_tf.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 64)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 64)).astype(np.int32)
    rloss, rgrads = jax.jit(jax.value_and_grad(lambda q: r_tf.lm_loss(
        q, toks, labels, rcfg, ShardCtx(mesh=None), seq_chunk=32)))(p)
    pt = tf.params_from_jax(cfg, {k: np.asarray(v) for k, v in p.items()},
                            device="cpu")
    loss, grads = _port_grads(cfg, pt, toks, labels)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-6)
    assert sorted(grads) == sorted(rgrads) and "wg_e" in grads
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(rgrads[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


# (B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, dtype)
_ATTN_CASES = [
    (2, 16, 16, 4, 4, 16, True, None, 0, torch.float32),    # GQA rep 1
    (2, 16, 16, 6, 2, 32, True, None, 0, torch.float32),    # rep 3
    (1, 12, 20, 3, 1, 64, True, None, 8, torch.float32),    # q_offset
    (2, 16, 16, 4, 2, 16, True, 5, 0, torch.float32),       # a window
    (1, 8, 24, 6, 2, 32, True, 6, 16, torch.float32),       # window, offset
    (1, 10, 14, 2, 2, 16, False, None, 0, torch.float32),   # no mask
    (2, 16, 16, 6, 2, 32, True, None, 0, torch.bfloat16),   # rep 3
    (1, 8, 24, 6, 2, 32, True, 6, 16, torch.bfloat16),      # window, offset
    (1, 10, 14, 2, 2, 16, False, None, 0, torch.bfloat16),  # no mask
]


def _bf16_bound(q, k, o, do, want, causal, window, q_offset):
    """How far the port's bf16 gradient may sit from an exact float32
    one (JAX's, or autograd's on float32 copies): the bf16 rounding of
    the output, within 2**-7 |want|, and 1e-4 of the largest element
    for the float32 sums (``ref.TOL_BWD``); and the forward's output
    rounded to bf16 (2**-8 of each element) before delta = rowsum(dO O),
    which moves delta_q by at most e_q = 2**-8 sum_d |O dO|, dS by P e_q,
    so dQ by scale sum_k P e_q |K| and dK by scale sum_q P e_q |Q|."""
    b, sq, hq, dh = q.shape
    hkv, scale = k.shape[2], dh ** -0.5
    rep = hq // hkv
    lse = fa_ref.attention_lse(q, k, causal=causal, window=window,
                               q_offset=q_offset)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(rep, 2)) * scale
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(k.shape[1])[None, :]
    mask = torch.ones(sq, k.shape[1], dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    p = torch.exp2(torch.where(mask, s, float("-inf")) * fa_ref.LOG2E
                   - lse[..., None])
    e = 2.0 ** -8 * (o.float() * do.float()).abs().sum(-1)    # (B, Sq, Hq)
    pe = p * e.transpose(1, 2)[..., None]
    dq = torch.einsum("bhqk,bkhd->bqhd", pe,
                      k.float().abs().repeat_interleave(rep, 2)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", pe, q.float().abs()) * scale
    dk = dk.reshape(b, -1, hkv, rep, dh).sum(3)
    extra = (dq, dk, torch.zeros_like(dk))
    return [fa_ref.backward_bound(w, torch.bfloat16) + x
            for w, x in zip(want, extra)]


@pytest.mark.parametrize("case", _ATTN_CASES,
                         ids=[f"c{i}" for i in range(len(_ATTN_CASES))])
def test_attention_backward_matches_autograd_and_jax(case):
    b, sq, sk, hq, hkv, dh, causal, window, off, dtype = case
    rng = np.random.default_rng(sum(case[:6]))
    qn, kn, vn, don = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
        .float().numpy() for s in ((b, sq, hq, dh), (b, sk, hkv, dh),
                                   (b, sk, hkv, dh), (b, sq, hq, dh)))
    # the port: kernel 9's Function (its plain versions on the CPU)
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_(True)
               for x in (qn, kn, vn))
    o = fa_ops.attention(q, k, v, causal=causal, window=window,
                         q_offset=off)
    do = torch.from_numpy(don).to(dtype)
    got = torch.autograd.grad(o, (q, k, v), do)
    # autograd of the plain forward, in float32 (the bf16 cases' values:
    # autograd in bf16 would round each query head's dK and dV before
    # summing them)
    q2, k2, v2 = (torch.from_numpy(x).requires_grad_(True)
                  for x in (qn, kn, vn))
    o2 = fa_ref.attention_gqa(q2, k2, v2, causal=causal, window=window,
                              q_offset=off)
    auto = torch.autograd.grad(o2, (q2, k2, v2), torch.from_numpy(don))
    # jax.grad of the JAX package's chunked_attention
    _, vjp = jax.vjp(lambda a, c, d: r_chunked_attention(
        a, c, d, q_offset=off, causal=causal, window=window,
        kv_chunk=1024), jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = [torch.from_numpy(np.array(w)) for w in vjp(jnp.asarray(don))]
    if dtype == torch.float32:
        for g, a, w, name in zip(got, auto, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"d{name} autograd")
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"d{name} jax")
            assert bool((torch.abs(g - a) <= fa_ref.backward_bound(a)).all())
        return
    for ref_grads, label in ((auto, "autograd"), (want, "jax")):
        bounds = _bf16_bound(q.detach(), k.detach(), o.detach(), do,
                             [x.float() for x in ref_grads], causal, window,
                             off)
        for g, a, bound, name in zip(got, ref_grads, bounds, "qkv"):
            assert g.dtype == torch.bfloat16
            err = (g.float() - a.float()).abs()
            assert bool((err <= bound).all()), \
                (label, name, float((err / bound).max()))


def test_attention_backward_dead_rows_get_zero():
    """A query row that no key reaches (a window behind a large
    q_offset) gets zero gradient, as the forward gives it zeros."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 8, generator=g)
    k = torch.randn(1, 6, 2, 8, generator=g)
    v = torch.randn(1, 6, 2, 8, generator=g)
    o = fa_ref.attention_gqa(q, k, v, window=2, q_offset=10)
    assert torch.equal(o, torch.zeros_like(o))
    dq, dk, dv = fa_ops.flash_attention_gqa_backward(
        q, k, v, o, torch.ones_like(o), window=2, q_offset=10)
    for x in (dq, dk, dv):
        assert torch.equal(x, torch.zeros_like(x))


def test_attention_backward_checks_its_inputs():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="o and do"):
        fa_ops.flash_attention_gqa_backward(q, k, k, q[..., :4], q)
    with pytest.raises(ValueError, match="dtype"):
        fa_ops.flash_attention_gqa_backward(q, k, k, q.double(), q)
