"""The port's flash attention, its dispatch and the global-mode slice
against the JAX package, on the CPU.

Inputs and weights come from numpy seeds and reach both sides as arrays (the
port's models through the weight bridge). The JAX flash kernel runs in
interpret mode, as tests/test_attention.py runs it; the port's CPU tensors
take ``flash_attention_plain``, whose backward is autograd's. The CUDA
kernels themselves are held against the plain version on the card by
chip_smoke.py (phase 3c). Tolerances: forward atol 2e-5 / rtol 1e-4 and
gradients atol 5e-4 / rtol 1e-3 (those of tests/test_attention.py for
flash against XLA); lse atol 1e-5 / rtol 1e-6; the global-mode sims within
1e-4 of max|JAX| with Recall and AUC equal; train steps at the tolerances
of tests/test_torch_train.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.evals import align as jalign
from exoground_tpu.losses.milnce import TANLossConfig as JaxLossConfig
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models import ema_init as jax_ema_init
from exoground_tpu.ops import attention as jattn
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel import make_tan_train_step as jax_make_step
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu_torch import ops as tops
from exoground_tpu_torch.evals import align as talign
from exoground_tpu_torch.evals.bench_items import make_global_items
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models import TemporalAligner, ema_init
from exoground_tpu_torch.ops import attention as tattn
from exoground_tpu_torch.ops import blocks as tblocks
from exoground_tpu_torch.parallel import make_tan_train_step
from exoground_tpu_torch.train import ExperimentConfig, FusedAdamWEMA, TANTrainer
from exoground_tpu_torch.utils.convert import load_tan_params, tan_state_dict_from_jax
from tests.test_torch_mha_family import _product
from tests.test_torch_train import LOSS, SMALL, _batch, _numpy_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(b, h, sq, sk, d, seed):
    return _rand(b, h, sq, d, seed=seed), _rand(b, h, sk, d, seed=seed + 1), \
        _rand(b, h, sk, d, seed=seed + 2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("b,h,sq,sk,d,masked", [
    (2, 4, 64, 64, 64, True),
    (1, 8, 96, 200, 64, True),  # non-multiple-of-tile lengths, Sq != Sk
    (2, 2, 130, 257, 32, True),
    (1, 2, 128, 128, 64, False),
    (2, 3, 50, 70, 40, True),   # the odd head size the CUDA kernel's 40-tile serves
])
def test_forward_matches_jax_flash(b, h, sq, sk, d, masked):
    q, k, v = _qkv(b, h, sq, sk, d, seed=4)
    kpad = np.zeros((b, sk), bool)
    if masked:
        kpad[0, int(sk * 0.7):] = True
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(kpad) if masked else None)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), _t(kpad) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_lse_and_empty_rows_match_jax_fwd_impl():
    """lse against the JAX kernel's own (``_flash_fwd_impl`` on inputs padded
    as ``flash_attention`` pads them); batch row 0 has no valid key: o = 0
    and lse = +1e30 exactly on both sides."""
    b, h, sq, sk, d, blk = 2, 2, 72, 100, 32, 64
    q, k, v = _qkv(b, h, sq, sk, d, seed=20)
    kpad = np.zeros((b, sk), np.int32)
    kpad[0] = 1
    kpad[1, 80:] = 1
    qs = q * (1.0 / np.sqrt(d))
    pad_q, pad_k = -(-sq // blk) * blk - sq, -(-sk // blk) * blk - sk

    def pad(a, n, value=0):
        return np.pad(a, [(0, 0), (0, n)] + [(0, 0)] * (a.ndim - 2), constant_values=value)

    jo, jlse = jattn._flash_fwd_impl(
        jnp.asarray(pad(qs.reshape(b * h, sq, d), pad_q)),
        jnp.asarray(pad(k.reshape(b * h, sk, d), pad_k)),
        jnp.asarray(pad(v.reshape(b * h, sk, d), pad_k)),
        jnp.asarray(pad(kpad, pad_k, value=1)), h, blk, blk)
    o, lse = tattn.flash_attention_plain(_t(qs.reshape(b * h, sq, d)),
                                         _t(k.reshape(b * h, sk, d)),
                                         _t(v.reshape(b * h, sk, d)), _t(kpad))
    jlse = np.asarray(jlse)[:, :sq]
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo)[:, :sq], atol=2e-5, rtol=1e-4)
    assert np.all(lse[:h].numpy() == np.float32(1e30)) and np.all(jlse[:h] == np.float32(1e30))
    assert not o[:h].any()


def test_fully_masked_batch_row_gives_zero_and_no_nan():
    """As tests/test_attention.py::test_fully_masked_batch_row_no_nan, and
    the port's row equals the JAX kernel's (0, not attention_plain's
    uniform average)."""
    b, h, s, d = 2, 2, 64, 32
    q, k, v = _qkv(b, h, s, s, d, seed=13)
    kpad = np.zeros((b, s), bool)
    kpad[0, :] = True
    tq = _t(q).requires_grad_()
    out = tattn.flash_attention(tq, _t(k), _t(v), _t(kpad))
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(kpad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    assert not out[0].any()
    assert tattn.attention_plain(_t(q), _t(k), _t(v), _t(kpad))[0].abs().max() > 0
    out.sum().backward()
    assert not torch.isnan(tq.grad).any()


def test_gradients_match_jax_flash():
    b, h, sq, sk, d = 2, 2, 96, 160, 32
    q, k, v = _qkv(b, h, sq, sk, d, seed=10)
    kpad = np.zeros((b, sk), bool)
    kpad[1, 100:] = True
    jk = jnp.asarray(kpad)
    want = jax.grad(lambda q, k, v: jnp.sum(jattn.flash_attention(q, k, v, jk) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (tattn.flash_attention(tq, tk, tv, _t(kpad)) ** 2).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


def _bf16_case(b, h, sq, sk, d, seed, empty_row):
    """bf16 inputs from numpy, a random upstream grad and a key padding with
    a ragged tail (and batch row 0 without a valid key when asked)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (sq, sk, sk))
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    kpad = np.zeros((b, sk), bool)
    kpad[-1, int(sk * 0.75):] = True
    if empty_row:
        kpad[0] = True
    return q, k, v, do, kpad


BF16_CASES = [
    (1, 2, 96, 200, 40, False),   # 64-row tiles cut unevenly on both axes
    (1, 2, 96, 200, 128, False),
    (2, 2, 130, 257, 64, True),   # and a batch row with no valid key
]


@pytest.mark.parametrize("b,h,sq,sk,d,empty_row", BF16_CASES)
def test_bfloat16_forward_matches_jax_flash(b, h, sq, sk, d, empty_row):
    """In bfloat16, flash_attention on the CPU (flash_attention_plain, the
    order the bf16 CUDA bodies are held to on the card) against the JAX
    kernel in interpret mode. Both scale q in bf16 (JAX rounds the scalar
    1/sqrt(D) to bf16 first, torch keeps it in f32) and round o once, so
    they differ by one bf16 step of o where f32 sums in another order
    round the other way (measured <= 6.5e-3 of max|JAX| over 4 seeds):
    limit 1e-2 of max|JAX|. An empty row gives 0 on both sides."""
    q, k, v, _, kpad = _bf16_case(b, h, sq, sk, d, 70 + d, empty_row)
    want = jattn.flash_attention(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)),
                                 jnp.asarray(kpad))
    got = tattn.flash_attention(*(_t(a).bfloat16() for a in (q, k, v)), _t(kpad))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    if empty_row:
        assert not got[0].any() and not want[0].any()


@pytest.mark.parametrize("b,h,sq,sk,d,empty_row", BF16_CASES)
def test_bfloat16_gradients_match_jax_flash(b, h, sq, sk, d, empty_row):
    """In bfloat16, autograd of flash_attention_plain against the JAX
    kernel's backward (dq and dk/dv kernels in interpret mode) for the same
    upstream grad. The JAX kernels round ds to bf16 before ds . k and
    ds^T . q and take delta from the bf16 o; autograd chains the f32 graph
    of the plain version: measured <= 1.02e-2 of max|JAX| over 4 seeds,
    limit 2e-2 of max|JAX| per gradient."""
    q, k, v, do, kpad = _bf16_case(b, h, sq, sk, d, 80 + d, empty_row)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, jnp.asarray(kpad)),
                     jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv = (_t(a).bfloat16().requires_grad_() for a in (q, k, v))
    tattn.flash_attention(tq, tk, tv, _t(kpad)).backward(_t(do).bfloat16())
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max(), err_msg=f"d{name}")


def test_kernel_wrappers_refuse_cpu_and_unserved_head_sizes():
    """The launch wrappers check before any build: CPU tensors never reach
    the library, at any head size (64, 136, 256: above 128 the wide bodies
    serve it, so the device is the reason); a head size that is not a
    multiple of 8 raises ValueError there, since ``flash_attention`` pads it
    before the call; a kpad that does not fit raises."""
    kpad = torch.zeros(1, 8, dtype=torch.int32)
    for d in (64, 136, 256):
        x = torch.zeros(2, 8, d)
        with pytest.raises(ValueError, match="CUDA"):
            tattn.flash_forward(x, x, x, kpad)
    y = torch.zeros(2, 8, 60)
    with pytest.raises(ValueError, match="multiple of 8"):
        tattn.flash_forward(y, y, y, kpad)
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="kpad"):
        tattn.flash_forward(q, q, q, torch.zeros(3, 8, dtype=torch.int32))


# ------------------------------------------- the float32 forward, 3xTF32
def _fwd_tiles_tf32(q, k, v, kpad, tile=64):
    """flash_fwd_tf32_kernel's order of work on float32 (BH, S, D) tensors
    (q pre-scaled): key tiles of 64 walked in order, s = q . k^T in 3xTF32,
    invalid keys at -inf, the online max m (from the finite -1e30) and sum
    l, acc = alpha acc + p . v in 3xTF32 with p in float32; then o = acc / l
    and lse = m + log l, an empty row at o = 0 and lse = +1e30."""
    bh, sq, _ = q.shape
    b, sk = kpad.shape
    valid = (kpad == 0).repeat_interleave(bh // b, dim=0)[:, None, :]
    m = torch.full((bh, sq, 1), tattn.NEG_INF)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros_like(q)
    for k0 in range(0, sk, tile):
        sl = slice(k0, k0 + tile)
        sc = torch.where(valid[..., sl], _product(q, k[:, sl]), torch.tensor(-np.inf))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + _product(p, v[:, sl].transpose(1, 2))
        m = m_new
    lm = torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(lm), torch.full_like(m, -tattn.NEG_INF))
    return acc / lm, lse[..., 0]


def test_float32_forward_tiles_in_3xtf32_match_jax_and_plain():
    """The f32 forward's order of work at the global path's padded length
    (Sq = Sk = 2096, the last 48 keys padding: 33 key tiles, the last one
    ragged) against flash_attention_plain (o and lse) and the JAX kernel in
    interpret mode, within 1e-4 of max|ref| (chip_smoke's float32 limit)."""
    b, h, s, d = 1, 2, 2096, 64
    q, k, v = _qkv(b, h, s, s, d, seed=50)
    kpad = np.zeros((b, s), bool)
    kpad[:, s - 48:] = True
    qs = torch.from_numpy(q.reshape(b * h, s, d) * np.float32(1.0 / np.sqrt(d)))
    kf, vf = (torch.from_numpy(a.reshape(b * h, s, d)) for a in (k, v))
    o, lse = _fwd_tiles_tf32(qs, kf, vf, _t(kpad).int())
    po, plse = tattn.flash_attention_plain(qs, kf, vf, _t(kpad).int())
    assert (o - po).abs().max() <= 1e-4 * po.abs().max()
    assert (lse - plse).abs().max() <= 1e-4 * plse.abs().max()
    want = np.asarray(jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(kpad))).reshape(b * h, s, d)
    assert np.abs(o.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_float32_forward_tiles_keep_the_empty_row_rule():
    """A batch row with no valid key: o = 0 and lse = +1e30 exactly, as
    flash_attention_plain and the JAX kernel give; the other rows agree."""
    b, h, sq, sk, d = 2, 2, 130, 257, 32
    q, k, v = _qkv(b, h, sq, sk, d, seed=51)
    kpad = np.zeros((b, sk), np.int32)
    kpad[0] = 1
    kpad[1, 200:] = 1
    qs = torch.from_numpy(q.reshape(b * h, sq, d) * np.float32(1.0 / np.sqrt(d)))
    kf, vf = (torch.from_numpy(a.reshape(b * h, sk, d)) for a in (k, v))
    o, lse = _fwd_tiles_tf32(qs, kf, vf, _t(kpad))
    po, plse = tattn.flash_attention_plain(qs, kf, vf, _t(kpad))
    assert not o[:h].any() and bool((lse[:h] == np.float32(1e30)).all())
    assert torch.equal(plse[:h], lse[:h])
    assert (o - po).abs().max() <= 1e-4 * po.abs().max()


# ------------------------------------------- the float32 backward, 3xTF32
def _dq_tiles_tf32(q, k, v, kpad, do, lse, delta, tile=64, terms=3):
    """flash_dq_tf32_kernel's order of work on float32 (BH, S, D) tensors
    (q pre-scaled): key tiles of 64 walked in order, s = q . k^T and dp =
    do . v^T in 3xTF32, p = exp(s - lse) at valid keys (0 elsewhere; an
    empty row's lse = +1e30 makes every p 0), ds = p (dp - delta) in
    float32, dq += ds . k in 3xTF32 with ds unrounded. ``terms=1``: plain
    TF32 products."""
    bh = q.shape[0]
    b, sk = kpad.shape
    valid = (kpad == 0).repeat_interleave(bh // b, dim=0)[:, None, :]
    dq = torch.zeros_like(q)
    for k0 in range(0, sk, tile):
        sl = slice(k0, k0 + tile)
        s = _product(q, k[:, sl], terms)
        dp = _product(do, v[:, sl], terms)
        p = torch.where(valid[..., sl], torch.exp(s - lse[..., None]), torch.zeros(()))
        ds = p * (dp - delta[..., None])
        dq = dq + _product(ds, k[:, sl].transpose(1, 2), terms)
    return dq


def _dkv_tiles_tf32(q, k, v, kpad, do, lse, delta, cols=64, terms=3):
    """flash_dkv_tf32_kernel's order of work: the query tiles walked in
    order, ``cols`` query columns at a time (64, or 32 at head tiles above
    64), s^T = k . q^T and dp^T = v . do^T in 3xTF32, p^T = exp(s^T - lse)
    at valid keys, ds^T = p^T (dp^T - delta), then dv += p^T . do (the
    unrounded p) and dk += ds^T . q in 3xTF32, all float32."""
    bh, sq, _ = q.shape
    b = kpad.shape[0]
    valid = (kpad == 0).repeat_interleave(bh // b, dim=0)[:, :, None]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, sq, cols):
        sl = slice(q0, q0 + cols)
        s = _product(k, q[:, sl], terms)
        dp = _product(v, do[:, sl], terms)
        p = torch.where(valid, torch.exp(s - lse[:, None, sl]), torch.zeros(()))
        ds = p * (dp - delta[:, None, sl])
        dv = dv + _product(p, do[:, sl].transpose(1, 2), terms)
        dk = dk + _product(ds, q[:, sl].transpose(1, 2), terms)
    return dk, dv


def _bwd_case(b, h, sq, sk, d, seed, pad_tail, empty_row):
    """float32 inputs, the upstream grad and the key padding of one case,
    with the forward's lse and delta = sum(do * o) from the plain version."""
    q, k, v = _qkv(b, h, sq, sk, d, seed=seed)
    do = _rand(b, h, sq, d, seed=seed + 3)
    kpad = np.zeros((b, sk), bool)
    if pad_tail:
        kpad[:, sk - pad_tail:] = True
    if empty_row:
        kpad[0] = True
    flat = [torch.from_numpy(a.reshape(b * h, -1, d)) for a in (q, k, v, do)]
    flat[0] = flat[0] * np.float32(1.0 / np.sqrt(d))  # pre-scaled, as the kernels get it
    o, lse = tattn.flash_attention_plain(*flat[:3], _t(kpad).int())
    delta = (flat[3] * o).sum(-1)
    return (q, k, v, do, kpad), flat, lse, delta


BWD_CASES = [
    (1, 2, 96, 200, 64, 50, False),   # ragged last tiles on both axes, padded keys
    (2, 2, 130, 257, 32, 0, True),    # a batch row with no valid key
    (1, 2, 100, 130, 96, 7, False),   # D 96 in the 128 tile: 32-column query tiles
    (1, 2, 96, 140, 128, 12, False),  # D 128
]


@pytest.mark.parametrize("b,h,sq,sk,d,pad_tail,empty_row", BWD_CASES)
def test_float32_backward_tiles_in_3xtf32_match_jax_and_plain(b, h, sq, sk, d, pad_tail,
                                                              empty_row):
    """The f32 dq and dk/dv bodies' order of work against autograd of
    flash_attention_plain and the JAX kernel's gradients (dq and dk/dv
    kernels in interpret mode) for the same upstream grad, each within 1e-4
    of max|ref| (chip_smoke's float32 limit); an empty batch row gives
    exactly zero gradients."""
    arrays, (qs, kf, vf, dof), lse, delta = _bwd_case(b, h, sq, sk, d, 90 + d, pad_tail,
                                                      empty_row)
    q, k, v, do, kpad = arrays
    kp = _t(kpad).int()
    dq = _dq_tiles_tf32(qs, kf, vf, kp, dof, lse, delta)
    dk, dv = _dkv_tiles_tf32(qs, kf, vf, kp, dof, lse, delta, cols=64 if d <= 64 else 32)
    qq, kk, vv = (x.clone().requires_grad_() for x in (qs, kf, vf))
    tattn.flash_attention_plain(qq, kk, vv, kp)[0].backward(dof)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, jnp.asarray(kpad)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # the JAX gradient is taken at the unscaled q: dq there is ours times the scale
    scale = np.float32(1.0 / np.sqrt(d))
    want = [np.asarray(w).reshape(b * h, -1, d) for w in vjp(jnp.asarray(do))]
    for name, got, plain, jax_ref, f in (("dq", dq, qq.grad, want[0], scale),
                                         ("dk", dk, kk.grad, want[1], 1.0),
                                         ("dv", dv, vv.grad, want[2], 1.0)):
        assert (got - plain).abs().max() <= 1e-4 * plain.abs().max(), name
        g = got.numpy() * f
        assert np.abs(g - jax_ref).max() <= 1e-4 * np.abs(jax_ref).max(), name
        if empty_row:
            assert not got[:h].any() and not plain[:h].any(), name


def test_float32_backward_needs_3xtf32():
    """Plain TF32 products (hi halves alone) in the same order of work miss
    the float32 limit of 1e-4 of max|plain| by a wide margin, for dq and
    dk/dv alike: the bodies' three products are needed."""
    arrays, (qs, kf, vf, dof), lse, delta = _bwd_case(1, 2, 96, 200, 64, 90, 50, False)
    kp = _t(arrays[4]).int()
    qq, kk, vv = (x.clone().requires_grad_() for x in (qs, kf, vf))
    tattn.flash_attention_plain(qq, kk, vv, kp)[0].backward(dof)
    one = (_dq_tiles_tf32(qs, kf, vf, kp, dof, lse, delta, terms=1),
           *_dkv_tiles_tf32(qs, kf, vf, kp, dof, lse, delta, terms=1))
    for got, plain in zip(one, (qq.grad, kk.grad, vv.grad)):
        assert (got - plain).abs().max() > 10 * 1e-4 * plain.abs().max()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the flash wrappers'
    checks run and a stand-in library takes the call."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _stand_in_library(monkeypatch):
    """The flash wrappers' C calls go to a stand-in library that records
    (entry point, arguments) and returns 0; the counters start at 0."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            return lambda *args: calls.append((fn, args)) or 0

    monkeypatch.setattr(tattn._kernels, "library", lambda name: Lib())
    monkeypatch.setattr(tattn._kernels, "stream_of", lambda t: 0)
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        monkeypatch.setitem(tattn._kernels.LAUNCHES, name, 0)
    return calls


def _card(t):
    return t.as_subclass(_OnCard)


def _offset(t):
    """A contiguous view of t's shape 4 bytes past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 4)
    return _card(buf[1:1 + t.numel()].view(t.shape))


def test_float32_forward_refuses_an_unaligned_operand(monkeypatch):
    """Every f32 body stages its operands by 16-byte cp.async, as the bf16
    ones do: the forward, dq and dk/dv raise ValueError on an offset view of
    q, k, v or (dq, dk/dv) do before any launch, and aligned operands reach
    the library once each."""
    calls = _stand_in_library(monkeypatch)
    q = _card(torch.zeros(2, 64, 32))
    kpad = _card(torch.zeros(1, 64, dtype=torch.int32))
    lse, delta = _card(torch.zeros(2, 64)), _card(torch.zeros(2, 64))
    tattn.flash_forward(q, q, q, kpad)
    tattn.flash_dq(q, q, q, kpad, q, lse, delta)
    tattn.flash_dkv(q, q, q, kpad, q, lse, delta)
    for arg, name in enumerate(("q", "k", "v", "do")):
        ops = [q, q, q, q]
        ops[arg] = _offset(q)
        match = f"{name} must start on a 16-byte boundary"
        if arg < 3:
            with pytest.raises(ValueError, match=match):
                tattn.flash_forward(*ops[:3], kpad)
        with pytest.raises(ValueError, match=match):
            tattn.flash_dq(*ops[:3], kpad, ops[3], lse, delta)
        with pytest.raises(ValueError, match=match):
            tattn.flash_dkv(*ops[:3], kpad, ops[3], lse, delta)
    assert [fn for fn, _ in calls] == ["flash_attn_forward", "flash_attn_dq", "flash_attn_dkv"]
    assert [tattn._kernels.LAUNCHES[n] for n in ("flash_fwd", "flash_dq", "flash_dkv")] == \
        [1, 1, 1]


def test_flash_backward_hands_the_kernels_an_aligned_upstream_grad(monkeypatch):
    """FlashAttention.backward on an upstream grad that is a contiguous view
    at an offset (a slice of a larger grad): dq and dk/dv get a 16-byte
    aligned copy of the same values (so their checks pass and both reach the
    library), with delta = sum(do * o) over it."""
    calls = _stand_in_library(monkeypatch)
    seen = []
    for name in ("flash_dq", "flash_dkv"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _f=real: seen.append(a) or _f(*a))
    rng = np.random.RandomState(60)
    q, k, v, o = (_card(_t(rng.standard_normal((2, 64, 32)).astype(np.float32)))
                  for _ in range(4))
    kpad = _card(torch.zeros(1, 64, dtype=torch.int32))
    lse = _card(torch.zeros(2, 64))
    do = _offset(q)
    do.copy_(_t(rng.standard_normal((2, 64, 32)).astype(np.float32)))
    assert do.is_contiguous() and do.data_ptr() % 16
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, kpad, o, lse))
    tattn.FlashAttention.backward(ctx, do)
    assert [fn for fn, _ in calls] == ["flash_attn_dq", "flash_attn_dkv"]
    for args in seen:
        got_do, delta = args[4], args[6]
        assert got_do.data_ptr() % 16 == 0 and torch.equal(got_do, do)
        torch.testing.assert_close(delta, (do * o).sum(-1), rtol=0, atol=0)


def test_ptxas_usage_reads_registers_and_spills():
    """tools/ptxas_usage.py's parser on ptxas's verbose log (the form nvcc
    -Xptxas -v prints for sm_90a): one row a kernel, its registers, spill
    bytes, stack and static shared memory."""
    from exoground_tpu_torch.tools import ptxas_usage

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2tf20flash_dq_tf32_kernelILi64EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN2tf20flash_dq_tf32_kernelILi64EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3tcb20flash_fwd_bf16_kernelILi128EEEvPK' for 'sm_90a'
ptxas info    : Function properties for _ZN3tcb20flash_fwd_bf16_kernelILi128EEEvPK
    24 bytes stack frame, 28 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 512 bytes smem, 400 bytes cmem[0]
"""
    rows = ptxas_usage.parse(log)
    assert [r["mangled"] for r in rows] == [
        "_ZN2tf20flash_dq_tf32_kernelILi64EEEvPKf", "_ZN3tcb20flash_fwd_bf16_kernelILi128EEEvPK"]
    assert [(r["registers"], r["spill_stores"], r["spill_loads"], r["stack"], r["static_smem"])
            for r in rows] == [(232, 0, 0, 0, 0), (255, 28, 36, 24, 512)]
    assert all(isinstance(r["kernel"], str) and r["kernel"] for r in rows)


# ---------------------------------------------------------------- dispatch
def test_resolve_impl():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tattn.resolve_impl(None, 2048, 2048, cpu) == "xla"
    assert tattn.resolve_impl("auto", 4096, 4096, cpu) == "xla"
    assert tattn.resolve_impl(None, 2048, 2048, cuda) == "flash"
    assert tattn.resolve_impl("auto", 2096, 2096, cuda) == "flash"
    assert tattn.resolve_impl(None, 2047, 2048, cuda) == "xla"
    assert tattn.resolve_impl("flash", 8, 8, cpu) == "flash"
    assert tattn.resolve_impl("xla", 4096, 4096, cuda) == "xla"
    assert tattn.resolve_impl("small", 64, 64, cpu) == "small"
    assert tattn.resolve_impl("small", 4096, 4096, cuda) == "small"
    # 'fused' is the blocks' and the MHA module's; a core under it resolves as 'auto'
    assert tattn.resolve_impl("fused", 2048, 2048, cuda) == "flash"
    assert tattn.resolve_impl("fused", 64, 64, cuda) == "xla"
    assert tattn.resolve_impl("fused", 2048, 2048, cpu) == "xla"
    with pytest.raises(ValueError):
        tattn.resolve_impl("triton", 64, 64, cpu)


@pytest.mark.parametrize("impl,error", [
    (None, None), ("auto", None), ("xla", None), ("flash", None),
    ("small", None), ("fused", None), ("bogus", ValueError),
])
def test_check_impl(impl, error):
    """The one test of an impl string: None means 'auto'; the window core
    'small' and the whole-block 'fused' pass; anything else names the
    impls."""
    if error is None:
        tops.check_impl(impl)
        return
    with pytest.raises(error, match="one of"):
        tops.check_impl(impl)


def test_block_level_later_impls_raise():
    """'small' and 'fused', the impls of later slices, build and run at
    every level on the CPU: the block, the encoder and TemporalAligner
    (equal to the 'xla' path where every window keeps a valid key)."""
    block = tblocks.ResidualAttentionBlock(128, 4)
    enc = tblocks.TemporalEncoder(128, 2, 4)
    x = torch.randn(1, 8, 128)
    with torch.no_grad():
        for impl in ("small", "fused"):
            assert block(x, impl=impl)[0].shape == (1, 8, 128)
            torch.testing.assert_close(enc(x, impl=impl), enc(x, impl="xla"), atol=2e-5,
                                       rtol=1e-4)
        assert enc(x, impl="fused", mlp_impl="fused").shape == (1, 2, 8, 128)
    for impl in ("small", "fused"):
        tm = TemporalAligner(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4,
                             input_dim=16, max_pos=64, attn_impl=impl, device="cpu")
        with torch.no_grad():
            out = tm.text_visual_sim(torch.randn(1, 8, 16), torch.randn(1, 3, 16))
        assert out["sim"].shape == (1, 1, 8, 3) and torch.isfinite(out["sim"]).all()


@pytest.mark.parametrize("impl", [None, "auto", "xla", "flash"])
def test_explicit_impl_bypasses_fused_mha(monkeypatch, impl):
    """A qualifying 64-frame window takes the fused-MHA kernel only under
    'auto' (attention.py:1072-1085); 'xla' and 'flash' take the unfused
    projections and their own core."""
    routed = []
    for name in ("fused_mha", "flash_attention", "attention_plain"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name,
                            lambda *a, _n=name, _f=real, **kw: routed.append(_n) or _f(*a, **kw))
    mod = tattn.MultiHeadAttention(128, 4)
    x = torch.randn(2, 64, 128)
    with torch.no_grad():
        mod(x, x, x, impl=impl)
    # on the CPU fused_mha is mha_plain, which calls attention_plain
    fused = ["fused_mha", "attention_plain"]
    assert routed == {None: fused, "auto": fused, "xla": ["attention_plain"],
                      "flash": ["flash_attention"]}[impl]


def _mha_params(rng, c):
    return {"in_proj_kernel": rng.standard_normal((c, 3 * c)).astype(np.float32) * c ** -0.5,
            "in_proj_bias": rng.standard_normal(3 * c).astype(np.float32) * 0.02,
            "out_proj_kernel": rng.standard_normal((c, c)).astype(np.float32) * c ** -0.5,
            "out_proj_bias": rng.standard_normal(c).astype(np.float32) * 0.02}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_mha_module_impl_matches_jax(impl):
    """MultiHeadAttention(impl=...) against the JAX module's apply(...,
    impl=...), with a fully-masked batch row: 'flash' gives the out-proj
    bias there and 'xla' the average of the row's values, on both sides."""
    c, h, s = 128, 4, 40
    rng = np.random.RandomState(30)
    p = _mha_params(rng, c)
    x = rng.standard_normal((3, s, c)).astype(np.float32)
    kpad = np.zeros((3, s), bool)
    kpad[0] = True
    kpad[2, 25:] = True
    jx = jnp.asarray(x)
    want = jattn.MultiHeadAttention(num_heads=h).apply({"params": p}, jx, jx, jx,
                                                       jnp.asarray(kpad), impl=impl)
    mod = tattn.MultiHeadAttention(c, h)
    mod.load_state_dict({"in_proj_weight": _t(p["in_proj_kernel"].T),
                         "in_proj_bias": _t(p["in_proj_bias"]),
                         "out_proj.weight": _t(p["out_proj_kernel"].T),
                         "out_proj.bias": _t(p["out_proj_bias"])})
    tx = _t(x)
    with torch.no_grad():
        got = mod(tx, tx, tx, _t(kpad), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    at_bias = np.allclose(got[0].numpy(), p["out_proj_bias"][None], atol=1e-6)
    assert at_bias is (impl == "flash")


# ------------------------------------------------------- global-mode slice
GARCH = dict(num_encoder_layers=2, num_joint_layers=2, width=128, heads=4, input_dim=64,
             max_pos=128)
GCFG = dict(method="global", seq_len=64, global_len_bucket=128)


@pytest.fixture(scope="module")
def global_pair():
    """JAX weights of the small aligner and the global-mode items
    (~300-frame videos, padded to 384 frames)."""
    shapes = jax.eval_shape(
        JaxAligner(**GARCH, attn_impl="xla").init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8, 64)), jnp.zeros((1, 2, 64)),
        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool))
    rng = np.random.RandomState(5)

    def draw(path, sd):
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 else sd.shape[0] ** -0.5)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return params, make_global_items(64, 64, vlens=[260, 300, 330])


def _recording(sim_fn, log):
    def fn(*args, **kw):
        out = sim_fn(*args, **kw)
        log.append(out["sim"])
        return out

    return fn


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_global_mode_matches_jax(global_pair, impl):
    params, items = global_pair
    jm = JaxAligner(**GARCH, attn_impl=impl)
    jsims, tsims = [], []
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jalign.test_alignment_htm(
        items, _recording(jalign.make_tan_sim_fn(jm, jparams), jsims),
        jalign.AlignEvalConfig(**GCFG))
    tm = TemporalAligner(**GARCH, attn_impl=impl, device="cpu")
    load_tan_params(tm, params)
    got = talign.test_alignment_htm(items, _recording(talign.make_tan_sim_fn(tm), tsims),
                                    talign.AlignEvalConfig(**GCFG))
    assert len(tsims) == len(jsims) == len(items)
    for g, w in zip(tsims, jsims):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert got == want


def test_sim_fn_runs_a_bfloat16_model_on_bfloat16_inputs(global_pair):
    """make_tan_sim_fn casts the features to the model's type, so a bfloat16
    model runs the global mode; its sims stay within bfloat16 rounding of
    the float32 model's."""
    params, items = global_pair
    sims = {}
    for dtype in (torch.float32, torch.bfloat16):
        tm = TemporalAligner(**GARCH, attn_impl="flash", device="cpu")
        load_tan_params(tm, params)
        log = []
        talign.test_alignment_htm(items[:1], _recording(talign.make_tan_sim_fn(tm.to(dtype)),
                                                        log), talign.AlignEvalConfig(**GCFG))
        sims[dtype] = log[0]
    assert sims[torch.bfloat16].dtype == np.float32 and np.isfinite(sims[torch.bfloat16]).all()
    want = sims[torch.float32]
    np.testing.assert_allclose(sims[torch.bfloat16], want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


# --------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def three_flash_steps():
    """The JAX step and the port's with attn_impl='flash', 3 steps from the
    same weights and batches (tests/test_torch_train.py::three_steps)."""
    jm = JaxAligner(**SMALL, attn_impl="flash")
    jparams = _numpy_params(JaxAligner(**SMALL, attn_impl="xla"), 0)["params"]
    opt_kw = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=0)
    mesh = make_mesh(1)
    jtx = JaxFusedAdamWEMA(jparams, eps=1e-3, **opt_kw)
    jstep = jax_make_step(jm, JaxLossConfig(**LOSS), jtx, mesh, ema_momentum=0.9)
    jp = replicate(jax.tree_util.tree_map(jnp.copy, jparams), mesh)
    jt = replicate(jax_ema_init(jparams), mesh)
    jo = replicate(jtx.init(jparams), mesh)

    tm = TemporalAligner(**SMALL, attn_impl="flash", device="cpu")
    load_tan_params(tm, {"params": jparams})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = FusedAdamWEMA(p, eps=1e-3, **opt_kw)
    step = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9)
    t, o = ema_init(p), tx.init(p)
    gen = torch.Generator().manual_seed(0)
    record = {}
    for i in range(3):
        b = _batch(10 + i)
        jp, jt, jo, jmet = jstep(jp, jt, jo, shard_batch(b, mesh), jax.random.PRNGKey(i))
        p, t, o, met = step(p, t, o, {k: torch.from_numpy(v) for k, v in b.items()}, gen)
        if i in (0, 2):
            record[i + 1] = dict(
                jax=({k: float(v) for k, v in jmet.items()},
                     tan_state_dict_from_jax({"params": jax.device_get(jp)}),
                     tan_state_dict_from_jax({"params": jax.device_get(jt)}),
                     tan_state_dict_from_jax({"params": jax.device_get(jo.mu)})),
                port=({k: float(v) for k, v in met.items()},
                      {k: v.clone() for k, v in p.items()},
                      {k: v.clone() for k, v in t.items()},
                      {k: v.clone() for k, v in o.mu.items()}))
    return record


@pytest.mark.parametrize("n_steps", [1, 3])
def test_flash_train_step_matches_jax(three_flash_steps, n_steps):
    (jmet, jp, jt, jmu), (met, p, t, mu) = (three_flash_steps[n_steps]["jax"],
                                            three_flash_steps[n_steps]["port"])
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k], jmet[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k, want in jmu.items():
        scale = max(want.abs().max().item(), 1e-12)
        np.testing.assert_allclose(mu[k].numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=f"first moment {k}")
    for name, want, got in (("params", jp, p), ("ema", jt, t)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{name} {k}")


def test_config_attn_impl_reaches_the_model():
    """ExperimentConfig.attn_impl is validated and, unless 'auto', set on the
    trainer's model (the JAX package's build_model, train/main.py:124)."""
    with pytest.raises(AssertionError):
        ExperimentConfig(attn_impl="small").validate()
    for impl, want in (("auto", "xla"), ("flash", "flash"), ("xla", "xla")):
        tm = TemporalAligner(**SMALL, attn_impl="xla", device="cpu")
        TANTrainer(tm, ExperimentConfig(model="init", attn_impl=impl), device="cpu")
        assert tm.attn_impl == want
