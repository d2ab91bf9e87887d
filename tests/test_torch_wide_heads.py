"""Head sizes past the fixed head tiles, against the JAX package on the CPU.

The wide-head bodies (csrc/wide_window.cuh; csrc/mha_tile.cuh 2d; the flash
kernels' namespace wd) run only on the card, where chip_smoke.py (phases 3,
3c-3f and 7b) holds them against their plain versions. Here, on the same
seeded inputs:

  * the port's MHA family (fused MHA, the block bodies, both int8 bodies: on
    CPU tensors their plain versions) against the JAX Pallas kernels in
    interpret mode at head sizes 96, 128 and 256;
  * the wide body's order of work emulated in float32: the qkv product as
    one GEMM in 3xTF32, then per (window, head) the scores summed over head
    slabs of 64 columns, each slab's product in 3xTF32, the softmax once,
    o slab by slab from v's slabs in 3xTF32, the out-projection in 3xTF32.
    It holds 1e-4 of max|plain| and of JAX; plain TF32 misses it;
  * the flash and window cores at head sizes that are not multiples of 8
    (the wrappers pad with zero columns on the card: emulated here) and
    past 128;
  * GroundingModel at feature_dim 1024 and 2048 (8 heads: head sizes 128
    and 256), E1D1, under every attention impl and an int8 policy, against
    the JAX model on the same weights.

Tolerances (max error / max|reference|): float32 1e-4 for the MHA family
and the emulation (chip_smoke's float32 limit: summation order over C up to
2048); 1e-5 for the window and flash cores' plain functions (one softmax,
sums over D); bfloat16 1e-2 (bf16 roundings of q, k, v and p); the int8
block body 1e-3 (a last-bit LayerNorm difference can move one value across
a rounding boundary: one int8 step of one of C terms); the grounding model
1e-4 in float32, and under int8 the int8 mode's floor (twice the port's
own change under 1e-7 input noise, at least 1e-3: eager JAX quantizers are
bit for bit the port's, but the float32 sums before them differ by
rounding, and at these widths many values sit at a .5 boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.models.grounding import GroundingModel as JaxGrounding
from exoground_tpu.ops import attention as jattn
from exoground_tpu.ops import quant as jquant
from exoground_tpu_torch.models import GroundingModel
from exoground_tpu_torch.ops import attention as tattn
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.utils.convert import load_grounding_params
from tests.test_torch_mha_family import _product, _prologue
from tests.test_torch_small import jax_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

# head size -> (C, H), C a multiple of 128 as the fused test admits
WIDE = {96: (768, 8), 128: (1024, 8), 256: (2048, 8)}
SLAB = 64  # head columns a slab of the wide bodies (wide_window.cuh kDS)
B = 2


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(s, dh, seed):
    """x with a zero row, ragged key padding (no fully-masked window: the
    JAX kernel attends across its packed neighbour there), LayerNorm and
    attention weights."""
    c, h = WIDE[dh]
    rng = np.random.RandomState(seed)
    x = _n(rng, B, s, c)
    x[1, 0] = 0.0
    kpad = np.zeros((B, s), bool)
    kpad[0, max(1, int(s * 0.7)):] = True
    ln = (1.0 + 0.05 * _n(rng, c), 0.05 * _n(rng, c))
    w = (_n(rng, 3 * c, c, scale=c ** -0.5), _n(rng, 3 * c, scale=0.02),
         _n(rng, c, c, scale=c ** -0.5), _n(rng, c, scale=0.02))
    return x, kpad, ln, w, h


# ------------------------------------------- the MHA family against JAX
BODIES = ("mha", "mha_int8", "block", "block_int8")
TOL = {("float32", False): 1e-4, ("float32", True): 1e-3, ("bfloat16", False): 1e-2,
       ("bfloat16", True): 1e-2}


@pytest.mark.parametrize("dh", sorted(WIDE))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", BODIES)
def test_mha_family_matches_jax_at_wide_heads(body, dtype, dh):
    """fused_mha, fused_mha_int8 and fused_block_attn (exact and int8) on
    CPU tensors against the JAX kernels in interpret mode (_fused_mha,
    _fused_mha_int8, fused_block_attn), S 64, head sizes 96, 128 and 256;
    the block bodies' x_norm too (1e-5 in float32, 1e-2 in bfloat16)."""
    x, kpad, (g, b), (wi, bi, wo, bo), h = _inputs(64, dh, seed=dh + len(body))
    td = getattr(torch, dtype)
    tx, tg, tb, twi, tbi, two, tbo = (torch.from_numpy(a).to(td) for a in (x, g, b, wi, bi, wo,
                                                                          bo))
    tk = torch.from_numpy(kpad)
    j = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    jk = jnp.asarray(kpad.astype(np.int32))
    with torch.no_grad():
        if body == "mha":
            got, got_n = tattn.fused_mha(tx, tk, twi, tbi, two, tbo, h), None
            want = jattn.fused_mha_small(j(x), jk, j(wi.T), j(bi), j(wo.T), j(bo), h)
        elif body == "mha_int8":
            got, got_n = tattn.fused_mha_int8(tx, tk, twi, tbi, two, tbo, h), None
            want = jattn._fused_mha_int8(j(x), jk, j(wi.T), j(bi), j(wo.T), j(bo), h)
        else:
            int8 = body == "block_int8"
            got, got_n = tattn.fused_block_attn(tx, tk, tg, tb, twi, tbi, two, tbo, h,
                                                int8_qkv=int8)
            want, want_n = jattn.fused_block_attn(j(x), jnp.asarray(kpad), j(g), j(b), j(wi.T),
                                                  j(bi), j(wo.T), j(bo), h, int8_qkv=int8)
    assert got.dtype == td and got.shape == x.shape
    assert _rel(got, want) <= TOL[(dtype, body == "block_int8")]
    if got_n is not None:
        assert _rel(got_n, want_n) <= (1e-5 if dtype == "float32" else 1e-2)


# --------------------------------- the wide body's order of work, float32
def _slabs(d):
    return [slice(d0, min(d0 + SLAB, d)) for d0 in range(0, d, SLAB)]


def _emulate_wide(a, kpad, w_in, b_in, w_out, b_out, num_heads, res=None, terms=3):
    """mha_tile.cuh 2d then the out-projection, in their order of work on
    float32: qkv = a . W_in^T + b_in by the tail's GEMM (3xTF32) into the
    scratch; per (window, head) the scores as the sum over head slabs of 64
    columns of q_slab . k_slab^T, each in 3xTF32, times 1/sqrt(Dh); padding
    keys at -1e30 (no packing: one window a CTA); p = exp(s - max), p / l in
    float32; each slab of o = (p / l) . v_slab in 3xTF32; then o . W_out^T
    in 3xTF32 + b_out (+ res). ``terms=1``: every product in plain TF32."""
    b, s, c = a.shape
    dh = c // num_heads
    qkv = _product(a.reshape(b * s, c), w_in, terms) + b_in
    q, k, v = (t.reshape(b, s, num_heads, dh).transpose(1, 2) for t in qkv.chunk(3, -1))
    sc = torch.zeros(b, num_heads, s, s)
    for sl in _slabs(dh):
        sc = sc + _product(q[..., sl], k[..., sl], terms)
    sc = sc * np.float32(1.0 / np.sqrt(dh))
    sc = torch.where(kpad.bool()[:, None, None, :], torch.tensor(tattn.NEG_INF), sc)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.cat([_product(p, v[..., sl].transpose(-1, -2), terms) for sl in _slabs(dh)], -1)
    o = o.transpose(1, 2).reshape(b * s, c)
    out = _product(o, w_out, terms) + b_out
    if res is not None:
        out = out + res.reshape(b * s, c)
    return out.reshape(b, s, c)


@pytest.mark.parametrize("dh", sorted(WIDE))
@pytest.mark.parametrize("body", ["mha", "block"])
def test_wide_body_in_3xtf32_matches_plain_and_jax(body, dh):
    """The float32 wide body's order of work (head slabs of 64 columns,
    every product in 3xTF32) against the plain version and the JAX kernel
    in interpret mode within 1e-4 of max|ref| (chip_smoke's float32 limit),
    S 96; the same with plain TF32 products misses it."""
    x, kpad, ln, w, h = _inputs(96, dh, seed=3 * dh)
    tx, tk = torch.from_numpy(x), torch.from_numpy(kpad)
    g, bb, wi, bi, wo, bo = (torch.from_numpy(a) for a in (*ln, *w))
    if body == "mha":
        a, res = tx, None
        want = tattn.mha_plain(tx, tk, wi, bi, wo, bo, h)
        jax_out = jattn.fused_mha_small(jnp.asarray(x), jnp.asarray(kpad), jnp.asarray(w[0].T),
                                        jnp.asarray(w[1]), jnp.asarray(w[2].T),
                                        jnp.asarray(w[3]), h)
    else:
        a, res = _prologue(tx, g, bb)[0].reshape(tx.shape), tx
        want = tattn.block_attn_plain(tx, tk, g, bb, wi, bi, wo, bo, h)[0]
        jax_out, _ = jattn.fused_block_attn(
            jnp.asarray(x), jnp.asarray(kpad), *(jnp.asarray(t) for t in ln),
            jnp.asarray(w[0].T), jnp.asarray(w[1]), jnp.asarray(w[2].T), jnp.asarray(w[3]), h)
    got = _emulate_wide(a, tk, wi, bi, wo, bo, h, res=res)
    tf32 = _emulate_wide(a, tk, wi, bi, wo, bo, h, res=res, terms=1)
    assert _rel(got, want) <= 1e-4
    assert _rel(got, jax_out) <= 1e-4
    assert _rel(tf32, want) > 1e-4


@pytest.mark.parametrize("dh", sorted(WIDE))
def test_wide_int8_body_projection_is_exact(dh):
    """The int8 wide body's projection (linear_s8_kernel: mma.sync .s8 over
    the whole K, exact int32 sums, dequantized as float(acc) * xs * wsc +
    b_in in the plain order) gives the plain version's qkv to the bit: the
    int32 sums do not depend on the order of the K steps."""
    x, _, _, (wi, bi, _, _), _ = _inputs(17, dh, seed=dh + 1)
    tx, twi, tbi = (torch.from_numpy(a) for a in (x, wi, bi))
    _, xf, xq, xs = _prologue(tx, quantize=True)
    wq, ws = quant.quantized_weight(twi)
    acc = torch.zeros(xq.shape[0], wq.shape[0], dtype=torch.int64)
    for k in range(0, xq.shape[1], 32):  # the k-steps of m16n8k32, in turn
        acc += xq[:, k:k + 32].long() @ wq[:, k:k + 32].long().T
    want_acc, want_xs, want_ws = quant.int8_product(xf, twi)
    assert torch.equal(acc.to(torch.int32), want_acc)
    got = acc.to(torch.int32).float() * xs * ws + tbi
    assert torch.equal(got, want_acc.float() * want_xs * want_ws + tbi)


# ------------------------------------------------- flash and window cores
def _qkv(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(_n(rng, b, h, s, d) for _ in range(3))


@pytest.mark.parametrize("d", [60, 100, 136, 256])
def test_padded_head_is_exact_for_the_cores(d):
    """What the wrappers do on the card at a head size that is not a
    multiple of 8 (60, 100), and the wide heads (136, 256) unpadded: zero
    head columns up to the next multiple of 8 leave the window core's and
    the flash kernels' function (o, and under autograd dq, dk, dv) as it is,
    the scale staying 1/sqrt(D) of the true D: the padded plain functions,
    sliced, equal the unpadded ones within float32 rounding (1e-6)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 40, d, seed=d))
    kpad = torch.zeros(2, 40, dtype=torch.int32)
    kpad[0, 30:] = 1
    d8 = -(-d // 8) * 8
    scale = 1.0 / np.sqrt(d)
    want = tattn.small_attention_plain(q * scale, k, v, kpad)
    qp, kp, vp = (tattn._pad_head(t, d8) for t in (q, k, v))
    got = tattn.small_attention_plain(qp * scale, kp, vp, kpad)[..., :d]
    assert got.shape == want.shape and _rel(got, want) <= 1e-6
    grads = []
    for pad in (False, True):
        ts = [t.clone().reshape(4, 40, d).requires_grad_() for t in (q, k, v)]
        args = [tattn._pad_head(t, d8) if pad else t for t in ts]
        o, _ = tattn.flash_attention_plain(args[0] * scale, args[1], args[2], kpad)
        o[..., :d].pow(2).sum().backward()
        grads.append([o[..., :d].detach()] + [t.grad for t in ts])
    for g, w in zip(*grads):
        assert g.shape == w.shape and _rel(g, w) <= 1e-6


@pytest.mark.parametrize("d", [60, 100, 136, 256])
def test_small_attention_matches_jax_at_any_head_size(d):
    """The port's small_attention on the CPU answers every head size the
    JAX function takes (none raises), within 1e-5 of max|JAX| in float32:
    D 60 and 100 (not multiples of 8), 136 and 256 (past the fixed tiles)."""
    q, k, v = _qkv(2, 2, 16, d, seed=40 + d)
    kpad = np.zeros((2, 16), bool)
    kpad[1, 11:] = True
    want = jattn.small_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(kpad))
    got = tattn.small_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(kpad))
    assert got.shape == (2, 2, 16, d)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("d", [60, 136, 256])
def test_flash_attention_matches_jax_at_wide_heads(d):
    """flash_attention (CPU: flash_attention_plain) against the JAX
    flash_attention in interpret mode, forward and gradients, at head sizes
    60, 136 and 256, with a ragged tail; 1e-5 of max|JAX| in float32."""
    q, k, v = _qkv(1, 2, 72, d, seed=50 + d)
    kpad = np.zeros((1, 72), bool)
    kpad[0, 60:] = True
    jk = jnp.asarray(kpad)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, jk, block_q=64, block_k=64) ** 2)

    want_o = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jk,
                                   block_q=64, block_k=64)
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tattn.flash_attention(*ts, torch.from_numpy(kpad))
    (o ** 2).sum().backward()
    assert _rel(o.detach(), want_o) <= 1e-5
    for t, w in zip(ts, want_g):
        assert _rel(t.grad, w) <= 1e-5


# --------------------------------------------- the model at full widths
GND = dict(vi_encoder_type="mlp", num_encoder_layers=1, num_decoder_layers=1,
           video_embed_dim=48, text_embed_dim=40)


def _gnd_inputs():
    rng = np.random.RandomState(5)
    vmask = np.zeros((2, 16), bool)
    vmask[1, 11:] = True
    lmask = np.zeros((2, 16), bool)
    lmask[0, 13:] = True
    return [_n(rng, 2, 16, 48), _n(rng, 2, 16, 40), vmask, lmask]


@pytest.fixture(scope="module", params=[1024, 2048])
def wide_grounding(request):
    """The JAX GroundingModel at the width (8 heads) on seeded weights, its
    'xla' forward in float32 and its forward under an int8 policy that
    quantizes the 3C- and 4C-column products but not the C-column ones
    (min_cols 2C), eager (under jit XLA multiplies by the reciprocal of
    127); and the port's model on the same weights."""
    width = request.param
    args = _gnd_inputs()
    jargs = [jnp.asarray(a) for a in args]
    jm = JaxGrounding(**GND, feature_dim=width, attn_impl="xla")
    params = jax_params(jm, *jargs, seed=width)
    want = jm.apply({"params": params}, *jargs, deterministic=True)["interval_preds"]
    with jquant.matmul_impl("int8", min_cols=2 * width):
        want8 = jm.apply({"params": params}, *jargs, deterministic=True)["interval_preds"]
    tm = GroundingModel(**GND, feature_dim=width, device="cpu")
    load_grounding_params(tm, params)
    del params
    return width, tm, [torch.from_numpy(a) for a in args], np.asarray(want), np.asarray(want8)


@pytest.mark.parametrize("impl", ["auto", "small", "flash", "fused", "int8"])
def test_grounding_model_at_full_width_matches_jax(wide_grounding, impl):
    """GroundingModel at feature_dim 1024 and 2048 (head sizes 128 and 256),
    E1D1, the port under 'auto', 'small', 'flash' and 'fused' against the
    JAX model's float32 forward (every impl computes the same function: no
    window is fully masked), 1e-4 of max|JAX|; under
    quant.matmul_impl('int8', min_cols=2C) ('auto': the int8 MHA and MLP
    bodies' plain versions) against the JAX model under the same policy at
    the int8 mode's floor (chip_smoke phase 7's): at these widths values at
    a rounding boundary of the quantizers are many, and the two packages'
    float32 sums before them differ by rounding, so the answers move by
    about what the port's own answers move when the video features change
    by 1e-7 (relative, one rounding step): twice the largest such change
    over 4 seeded draws, at least 1e-3 (the readings: 4.9e-3 at C 1024 and
    1.8e-3 at C 2048 against floors of 5e-4 to 6.7e-3)."""
    width, tm, args, want, want8 = wide_grounding
    tm.attn_impl = None if impl == "int8" else impl
    if impl != "int8":
        with torch.no_grad():
            got = tm(*args, deterministic=True)["interval_preds"]
        assert got.shape == want.shape and np.isfinite(_f32(got)).all()
        assert _rel(got, want) <= 1e-4
        return

    def int8(inputs):
        with torch.no_grad(), quant.matmul_impl("int8", min_cols=2 * width):
            return tm(*inputs, deterministic=True)["interval_preds"]

    got = int8(args)
    floor = 0.0
    for seed in range(4):
        noise = np.random.RandomState(seed).standard_normal(tuple(args[0].shape))
        nudged = [args[0] * (1.0 + 1e-7 * torch.from_numpy(noise.astype(np.float32))), *args[1:]]
        floor = max(floor, _rel(int8(nudged), got))
    assert got.shape == want8.shape and np.isfinite(_f32(got)).all()
    assert _rel(got, want8) <= max(1e-3, 2.0 * floor)
