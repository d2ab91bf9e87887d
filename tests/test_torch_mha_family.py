"""The MHA family's bodies (csrc/mha_tile.cuh) checked on the CPU.

The CUDA kernels run only on the card (chip_smoke.py phases 3, 3d and 3e hold
them against their plain versions there). Here their order of work is
emulated on the same inputs and held against the plain versions and the JAX
Pallas kernels in interpret mode, as tests/test_torch_blocks.py runs them:
the row prologue once per row (the LayerNorm statistics as one warp sums
them, x_norm, the int8 quantization of x or of the unrounded float32 x_norm
with whole-row scales), the int32 sums per 128-wide K chunk dequantized in
the plain version's order, and the attention at the bodies' rounding points
(float32: q, k, v and p in float32; bfloat16: q, k, v and p rounded to
bfloat16 as the tensor-core tile rounds them). Beside it: what the wrappers
hand the kernels (the cached int8 W_in, the prologue's buffers) and their
alignment checks, through a stand-in library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.ops import attention as jattn
from exoground_tpu_torch.ops import _kernels, quant
from exoground_tpu_torch.ops import attention as tattn
from exoground_tpu_torch.ops.fused_mlp import LN_EPS, layernorm_f32
from tests.test_torch_mlp_family import _tf32
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

BODIES = ("mha_int8", "block", "block_int8")
# max error / max|reference|: float32 summation order (the int8 block body: a
# last-bit LN difference can flip one int8 step of one of C terms), bfloat16
# roundings of q, k, v and p; chip_smoke's limits (TOL, BLOCK_TOL)
TOL = {("float32", False): 1e-4, ("float32", True): 1e-3, ("bfloat16", False): 1e-2,
       ("bfloat16", True): 1e-2}
KC_INT8 = 128  # K of one step of the int8 products (bf16 tile and f32 words alike)
# head size -> (C, H): C a multiple of 128, as kernel_eligible admits
HEADS = {8: (128, 16), 40: (640, 16), 64: (128, 2)}
B = 3


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------ the row prologue
def _warp_sum(parts):
    """The butterfly of __shfl_xor_sync over (rows, 32) lane partials; every
    lane ends with the same sum."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        parts = parts + parts[:, lanes ^ o]
    return parts[:, 0:1]


def _warp_ln_stats(xf):
    """common.cuh::warp_ln_stats on each row: lane l sums k = l + 32 i in
    order, the warp sums the lanes; the mean of the squared deviations as
    fused multiply-adds (double, then rounded: exact products); rstd =
    1 / sqrt(var + eps) in float32."""
    rows, c = xf.shape
    lanes = xf.reshape(rows, c // 32, 32)
    s = torch.zeros(rows, 32)
    for i in range(c // 32):
        s = s + lanes[:, i]
    mean = _warp_sum(s) / c
    v = torch.zeros(rows, 32)
    for i in range(c // 32):
        d = lanes[:, i] - mean
        v = (d.double() * d.double() + v.double()).float()
    return mean, 1.0 / torch.sqrt(_warp_sum(v) / c + LN_EPS)


def _prologue(x, ln_w=None, ln_b=None, quantize=False):
    """row_prologue_kernel: (xn in x's type or None, the float32 values it
    quantizes, xq int8 and xs (rows, 1) float32 or None)."""
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    xn = None
    if ln_w is not None:
        mean, rstd = _warp_ln_stats(xf)
        xf = (xf - mean) * rstd * ln_w.float() + ln_b.float()  # each step rounded
        xn = xf.to(x.dtype)
    if not quantize:
        return xn, xf, None, None
    absmax = xf.abs().amax(-1, keepdim=True)
    xs = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0), torch.ones_like(absmax))
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xn, xf, xq, xs


# ------------------------------------------------------ the attention bodies
def _int8_qkv(xq, xs, w_in, b_in):
    """The int32 sums per 128-wide K chunk, then float(acc) * xs * ws + b_in,
    each step rounded, in the plain version's order; returns (qkv float32,
    the int32 sums)."""
    wq, ws = quant.quantized_weight(w_in)
    acc = torch.zeros(xq.shape[0], wq.shape[0], dtype=torch.int64)
    for k in range(0, xq.shape[1], KC_INT8):
        acc += xq[:, k:k + KC_INT8].long() @ wq[:, k:k + KC_INT8].long().T
    assert acc.abs().max() < 2 ** 31  # int32 sums: exact
    acc = acc.to(torch.int32)
    return acc.float() * xs * ws + b_in.float(), acc


def _attend(qkv, kpad, num_heads, s, bf16):
    """The per-window attention of one body on (B*S, 3C) float32 qkv: bf16
    rounds q, k, v, then p / l, to bfloat16 (the tensor-core tile); float32
    keeps them (the (window, head) kernel). Scores times 1/sqrt(Dh) in
    float32, padding keys at -1e30, so a fully-masked window averages its own
    values. Returns o (B*S, C) float32 (o in the body's type, as float32)."""
    c = qkv.shape[-1] // 3
    dh = c // num_heads
    if bf16:
        qkv = qkv.to(torch.bfloat16).float()
    q, k, v = (t.reshape(-1, s, num_heads, dh).transpose(1, 2) for t in qkv.chunk(3, -1))
    sc = (q @ k.transpose(-1, -2)) * (1.0 / np.sqrt(dh)).astype(np.float32)
    sc = sc.masked_fill(kpad.bool()[:, None, None, :], tattn.NEG_INF)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    if bf16:
        p = p.to(torch.bfloat16).float()
    o = (p @ v).transpose(1, 2).reshape(-1, c)
    return o.to(torch.bfloat16).float() if bf16 else o


def _emulate(body, x, kpad, ln_w, ln_b, w_in, b_in, w_out, b_out, num_heads):
    """One call of the family's body, in its order of work: the prologue,
    the qkv product, the attention, the out-projection with b_out (and the
    residual) in float32, rounded once. Returns out, x_norm (None in the int8
    MHA), the float32 qkv and o."""
    b, s, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    ln = body != "mha_int8"
    int8 = body != "block"
    xn, xf, xq, xs = _prologue(x, ln_w, ln_b, quantize=int8) if ln else _prologue(x, quantize=True)
    if int8:
        qkv, _ = _int8_qkv(xq, xs, w_in, b_in)
    else:  # the exact body reads x_norm as fused MHA reads x
        qkv = xn.float() @ w_in.float().T + b_in.float()
    o = _attend(qkv, kpad, num_heads, s, bf16)
    out = o @ w_out.float().T + b_out.float()
    if ln:
        out = out + x.reshape(-1, c).float()
    return (out.to(x.dtype).reshape(b, s, c), None if xn is None else xn.reshape(b, s, c),
            qkv, o)


# ------------------------------------------------------------------ inputs
def _inputs(s, dh, seed, masked_window=False):
    c, h = HEADS[dh]
    rng = np.random.RandomState(seed)
    x = _n(rng, B, s, c)
    x[1, 0] = 0.0  # a zero row: int8 scale 1, LN gives its bias
    kpad = np.zeros((B, s), bool)
    kpad[0, max(1, int(s * 0.8)):] = True
    kpad[2, max(1, s // 3):] = True
    if masked_window:
        kpad[1] = True  # a padded group window
    ln = (1.0 + 0.05 * _n(rng, c), 0.05 * _n(rng, c))
    w = (_n(rng, 3 * c, c, scale=c ** -0.5), _n(rng, 3 * c, scale=0.02),
         _n(rng, c, c, scale=c ** -0.5), _n(rng, c, scale=0.02))
    return x, kpad, ln, w, h


def _torch_args(x, kpad, ln, w, dtype):
    td = getattr(torch, dtype)
    return (torch.from_numpy(x).to(td), torch.from_numpy(kpad),
            *(torch.from_numpy(a).to(td) for a in (*ln, *w)))


def _plain(body, x, kpad, ln_w, ln_b, w_in, b_in, w_out, b_out, h):
    if body == "mha_int8":
        return tattn.mha_int8_plain(x, kpad, w_in, b_in, w_out, b_out, h), None
    plain = tattn.block_attn_int8_plain if body == "block_int8" else tattn.block_attn_plain
    return plain(x, kpad, ln_w, ln_b, w_in, b_in, w_out, b_out, h)


_JAX = {}


def _jax_kernel(body, s, dh, dtype, seed):
    """The JAX Pallas kernel (interpret mode) on the inputs, once per case:
    the output (and x_norm for the block bodies)."""
    key = (body, s, dh, dtype, seed)
    if key not in _JAX:
        x, kpad, (g, b), (wi, bi, wo, bo), h = _inputs(s, dh, seed)
        j = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
        if body == "mha_int8":
            out = jattn._fused_mha_int8(j(x), jnp.asarray(kpad.astype(np.int32)), j(wi.T), j(bi),
                                        j(wo.T), j(bo), h)
            _JAX[key] = (_f32(out), None)
        else:
            out, xn = jattn.fused_block_attn(j(x), jnp.asarray(kpad), j(g), j(b), j(wi.T), j(bi),
                                             j(wo.T), j(bo), h, int8_qkv=body == "block_int8")
            _JAX[key] = (_f32(out), _f32(xn))
    return _JAX[key]


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("dh", [8, 40, 64])
@pytest.mark.parametrize("s", [17, 64, 96, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", BODIES)
def test_order_of_work_matches_plain_and_jax(body, dtype, s, dh):
    """The emulated body against the plain version and the JAX kernel in
    interpret mode (every window with a valid key: the JAX kernel attends
    across its packed neighbour in a fully-masked one), for each body, type,
    window length (17: a ragged tile; 96: a third of the bf16 tile padding;
    128: the whole tile) and head size (8, 40 and 64: head tiles 16, 48
    and 64)."""
    seed = 7 * s + dh
    x, kpad, ln, w, h = _inputs(s, dh, seed)
    args = _torch_args(x, kpad, ln, w, dtype)
    got, got_n, _, _ = _emulate(body, *args, h)
    want, want_n = _plain(body, *args, h)
    assert got.dtype == want.dtype == getattr(torch, dtype) and got.shape == want.shape
    tol = TOL[(dtype, body == "block_int8")]
    assert _rel(got, want) <= tol
    jax_out, jax_n = _jax_kernel(body, s, dh, dtype, seed)
    assert _rel(got, jax_out) <= tol
    if body != "mha_int8":
        x_norm_tol = 1e-5 if dtype == "float32" else 1e-2  # chip_smoke's X_NORM_TOL
        assert _rel(got_n, want_n) <= x_norm_tol
        assert _rel(got_n, jax_n) <= x_norm_tol


@pytest.mark.parametrize("c", [128, 640])
def test_prologue_x_norm_is_layernorm_f32(c):
    """The prologue's LN statistics, summed as one warp sums them, give
    layernorm_f32 to the float32 limit (a last-bit difference)."""
    rng = np.random.RandomState(c)
    x = torch.from_numpy(_n(rng, 300, c, scale=3.0) + 1.5)
    g, b = (torch.from_numpy(a) for a in (1.0 + 0.1 * _n(rng, c), 0.1 * _n(rng, c)))
    _, got, _, _ = _prologue(x, g, b)
    want = layernorm_f32(x, g, b)
    assert _rel(got, want) <= 1e-6
    assert (got == want).float().mean() > 0.5  # the same arithmetic, most values to the bit


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prologue_quantizes_the_unrounded_float32_row(dtype, ln):
    """xq and xs are array-equal to quant._quant_last_axis of the float32
    values the prologue forms (x as float32, or the unrounded float32
    x_norm, not the x_norm it writes in x's type), a zero row at scale 1."""
    x, _, (g, b), _, _ = _inputs(64, 64, 11)
    td = getattr(torch, dtype)
    tx, tg, tb = (torch.from_numpy(a).to(td) for a in (x, g, b))
    xn, xf, xq, xs = _prologue(tx, tg if ln else None, tb if ln else None, quantize=True)
    want_q, want_s = quant._quant_last_axis(xf)
    assert torch.equal(xq, want_q) and torch.equal(xs, want_s)
    if not ln:
        assert torch.equal(xq, quant._quant_last_axis(tx.reshape(-1, tx.shape[-1]))[0])
        assert xs[64].item() == 1.0  # x[1, 0] is the zero row
    elif dtype == "bfloat16":
        rounded_q, _ = quant._quant_last_axis(xn.float())
        assert not torch.equal(xq, rounded_q)  # the bf16 x_norm would quantize otherwise


@pytest.mark.parametrize("ln", [False, True])
def test_int8_sums_per_chunk_are_the_plain_product(ln):
    """The int32 sums over 128-wide K chunks equal quant.int8_product's
    exact sums, and the dequantized qkv equals the plain version's to the
    bit (the same steps in the same order)."""
    x, _, (g, b), (wi, bi, _, _), _ = _inputs(96, 40, 12)
    tx, tg, tb, tw, tbi = (torch.from_numpy(a) for a in (x, g, b, wi, bi))
    _, xf, xq, xs = _prologue(tx, tg if ln else None, tb if ln else None, quantize=True)
    qkv, acc = _int8_qkv(xq, xs, tw, tbi)
    want_acc, want_xs, want_ws = quant.int8_product(xf, tw)
    assert torch.equal(acc, want_acc)
    assert torch.equal(qkv, want_acc.float() * want_xs * want_ws + tbi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", BODIES)
def test_fully_masked_window_averages_its_own_values(body, dtype):
    """A padded group window (every key padding) averages its own S values
    at the bodies' rounding points, as the plain version does; its
    neighbours are as they are alone."""
    x, kpad, ln, w, h = _inputs(64, 64, 13, masked_window=True)
    args = _torch_args(x, kpad, ln, w, dtype)
    got, _, qkv, o = _emulate(body, *args, h)
    want, _ = _plain(body, *args, h)
    assert _rel(got, want) <= TOL[(dtype, body == "block_int8")]
    tx, tk, g, b, wi, bi, wo, bo = args
    alone = _emulate(body, tx[1:2], tk[1:2], g, b, wi, bi, wo, bo, h)[0]
    assert torch.equal(got[1:2], alone)
    c = tx.shape[-1]
    v = qkv.reshape(B, 64, 3 * c)[1, :, 2 * c:]
    mean = v.to(tx.dtype).float().mean(0)  # v at the body's rounding
    o1 = o.reshape(B, 64, c)[1]
    assert (o1 == o1[0]).all()  # every query row sees the same average
    assert _rel(o1[0], mean.to(tx.dtype)) <= (1e-6 if dtype == "float32" else 1e-2)


# ------------------------------------------ the float32 exact body, 3xTF32
def _product(a, b, terms=3):
    """a . b^T over the last two axes as the tensor cores compute it on
    float32: 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi, each TF32 product
    exact in float32), or with ``terms=1`` plain TF32 (a_hi b_hi alone)."""
    ah, bh = _tf32(a), _tf32(b)
    hh = ah @ bh.transpose(-1, -2)
    if terms == 1:
        return hh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2) + hh


def _tiles(b, s):
    """The float32 tile's packing: each window takes RW = round16(S) rows,
    128 // RW windows a tile."""
    rw = -(-s // 16) * 16
    wpc = 128 // rw
    return rw, wpc, -(-b // wpc)


def _emulate_tf32(x, kpad, w_in, b_in, w_out, b_out, num_heads, res=None, terms=3):
    """mha_tf32_kernel, then the out-projection (linear_bias_tf32_kernel),
    in their order of work on float32: the windows packed into tiles, per
    head the tile's qkv product (+ b_in) in 3xTF32, scores over the whole
    tile in 3xTF32 times 1/sqrt(Dh) with the keys of the packed neighbours
    and past S at -inf and padding keys at -1e30, p = exp(s - max) / l in
    float32, o = p . v in 3xTF32; then o . W_out^T in 3xTF32 + b_out (+ res),
    summed in float32. Returns out (B, S, C)."""
    b, s, c = x.shape
    dh = c // num_heads
    rw, wpc, nt = _tiles(b, s)
    rows = wpc * rw
    xt = torch.zeros(nt * wpc, rw, c)
    xt[:b, :s] = x
    xt = xt.reshape(nt, rows, c)
    flag = torch.ones(nt * wpc, rw, dtype=torch.bool)  # padding keys
    flag[:b, :s] = kpad.bool()
    flag = flag.reshape(nt, rows)
    win = torch.arange(rows) // rw
    tok = torch.arange(rows) % rw
    own = (win[:, None] == win[None, :]) & (tok[None, :] < s)  # (query, key) of one window
    qkv = _product(xt, w_in, terms) + b_in
    q, k, v = (t.reshape(nt, rows, num_heads, dh).transpose(1, 2) for t in qkv.chunk(3, -1))
    sc = _product(q, k, terms) * np.float32(1.0 / np.sqrt(dh))
    sc = torch.where(flag[:, None, None, :], torch.tensor(tattn.NEG_INF), sc)
    sc = torch.where(own, sc, torch.tensor(-np.inf))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = _product(p, v.transpose(-1, -2), terms)  # (nt, H, rows, dh)
    o = o.transpose(1, 2).reshape(nt * wpc, rw, c)[:b, :s].reshape(b * s, c)
    out = _product(o, w_out, terms) + b_out
    if res is not None:
        out = out + res.reshape(b * s, c)
    return out.reshape(b, s, c)


def _jax_exact(body, x, kpad, ln, w, h):
    """The JAX kernel of the exact body (interpret mode) on float32 inputs."""
    g, bb = (jnp.asarray(a) for a in ln)
    wi, bi, wo, bo = w
    if body == "mha":
        return _f32(jattn._fused_mha(jnp.asarray(x), jnp.asarray(kpad.astype(np.int32)),
                                     jnp.asarray(wi.T), jnp.asarray(bi), jnp.asarray(wo.T),
                                     jnp.asarray(bo), h))
    out, _ = jattn.fused_block_attn(jnp.asarray(x), jnp.asarray(kpad), g, bb, jnp.asarray(wi.T),
                                    jnp.asarray(bi), jnp.asarray(wo.T), jnp.asarray(bo), h)
    return _f32(out)


def _exact_case(body, s, dh, seed, masked_window=False):
    """(the emulated float32 tile's output, plain TF32's, the plain version's,
    the inputs) for fused MHA ('mha') or the exact block body ('block'),
    which reads the prologue's x_norm as fused MHA reads x and adds x."""
    x, kpad, ln, w, h = _inputs(s, dh, seed, masked_window)
    tx, tk, g, bb, wi, bi, wo, bo = _torch_args(x, kpad, ln, w, "float32")
    if body == "mha":
        a, res = tx, None
        want = tattn.mha_plain(tx, tk, wi, bi, wo, bo, h)
    else:
        a, res = _prologue(tx, g, bb)[0].reshape(tx.shape), tx
        want = tattn.block_attn_plain(tx, tk, g, bb, wi, bi, wo, bo, h)[0]
    got, tf32 = (_emulate_tf32(a, tk, wi, bi, wo, bo, h, res=res, terms=t) for t in (3, 1))
    return got, tf32, want, (x, kpad, ln, w, h)


@pytest.mark.parametrize("body,s,dh", [("mha", s, dh) for s in (17, 64, 96, 128)
                                       for dh in (8, 40, 64)]
                         + [("block", s, 64) for s in (17, 64, 96, 128)])
def test_float32_tile_in_3xtf32_matches_plain_and_jax(body, s, dh):
    """The float32 exact body's order of work (windows packed at round16(S)
    rows, 128 // round16(S) a tile: two at S 64, one 96-row tile at S 96;
    every product in 3xTF32; the out-projection in 3xTF32 with b_out and, in
    the block body, the residual) against the plain version and the JAX
    kernel in interpret mode, within 1e-4 of max|ref| (chip_smoke's float32
    limit)."""
    got, _, want, (x, kpad, ln, w, h) = _exact_case(body, s, dh, seed=9 * s + dh)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-4
    assert _rel(got, _jax_exact(body, x, kpad, ln, w, h)) <= 1e-4


@pytest.mark.parametrize("body", ["mha", "block"])
@pytest.mark.parametrize("s", [64, 96])
def test_plain_tf32_misses_the_float32_bar(body, s):
    """What the 3xTF32 split buys: at the main path's windows the tile with
    a_hi b_hi alone (plain TF32, operands truncated to 10 mantissa bits)
    misses 1e-4 of max|plain| by far, while 3xTF32 sits at float32's own
    summation-order level."""
    got, tf32, want, _ = _exact_case(body, s, 64, seed=s + 5)
    assert _rel(got, want) <= 1e-5
    assert _rel(tf32, want) > 1e-3


def test_float32_out_projection_in_3xtf32():
    """The out-projection alone in 3xTF32 (heads summed inside one dot
    product over K = C), with the bias and residual added to the float32 sum
    once, against float64: float32 accuracy; plain TF32 misses 1e-4."""
    rng = np.random.RandomState(3)
    a, wo = torch.from_numpy(_n(rng, 300, 512)), torch.from_numpy(_n(rng, 512, 512, scale=0.05))
    bo, res = torch.from_numpy(_n(rng, 512, scale=0.02)), torch.from_numpy(_n(rng, 300, 512))
    ref = a.double() @ wo.double().T + bo.double() + res.double()
    scale = ref.abs().max()
    err = ((_product(a, wo) + bo + res).double() - ref).abs().max() / scale
    err1 = ((_product(a, wo, terms=1) + bo + res).double() - ref).abs().max() / scale
    assert err <= 1e-6 and err1 > 1e-4


def test_float32_tile_packs_a_fully_masked_window_beside_a_real_one():
    """Window 1 (every key padding) shares its 128-row tile with window 0 at
    S 64: it averages its own S values (its neighbour's keys take -inf, its
    own -1e30), as the plain version does, and window 0 is as it is alone."""
    got, _, want, (x, kpad, ln, w, h) = _exact_case("mha", 64, 64, 13, masked_window=True)
    assert kpad[1].all() and _tiles(3, 64)[:2] == (64, 2)
    assert _rel(got, want) <= 1e-4
    tx, tk, _, _, wi, bi, wo, bo = _torch_args(x, kpad, ln, w, "float32")
    alone = _emulate_tf32(tx[:1], tk[:1], wi, bi, wo, bo, h)
    assert torch.equal(got[:1], alone)
    qkv = _product(tx[1], wi) + bi
    mean = qkv[:, 2 * 128:].mean(0)  # v of window 1, averaged over its 64 rows
    o = _product(mean[None], wo) + bo
    assert _rel(got[1], o.expand(64, -1)) <= 1e-5


# ----------------------------------------------------- the wrappers' calls
def _fake_library(monkeypatch, calls):
    """Stand in for the kernel libraries: record each C call and return 0
    (the wide bodies' launch counts, which the MHA wrappers read after each
    call, are 0 and not recorded)."""
    class Lib:
        def __getattr__(self, fn):
            if fn in _kernels.BODY_COUNTERS.values():
                return lambda: 0

            def entry(*args):
                calls.append((fn, args))
                return 0
            return entry

    monkeypatch.setattr(_kernels, "library", lambda name: Lib())
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    for name in ("fused_mha", "fused_mha_int8", "block_attn", "block_attn_int8"):
        monkeypatch.setitem(_kernels.LAUNCHES, name, 0)


WRAPPERS = [("fused_mha", False, False), ("fused_mha_int8", False, True),
            ("block_attn", True, False), ("block_attn_int8", True, True)]


def _wrapper_args(b, s, c, dtype=torch.bfloat16):
    rng = np.random.RandomState(b * s + c)
    x = torch.from_numpy(_n(rng, b, s, c)).to(dtype)
    ln = dict(ln_w=torch.ones(c, dtype=dtype), ln_b=torch.zeros(c, dtype=dtype))
    w = [torch.from_numpy(_n(rng, 3 * c, c)).to(dtype), torch.zeros(3 * c, dtype=dtype),
         torch.from_numpy(_n(rng, c, c)).to(dtype), torch.zeros(c, dtype=dtype)]
    return x, ln, w


def _call(name, block, int8, x, ln, w, h=8):
    with torch.no_grad():
        return tattn._launch_mha(name, x, None, *w, h, ln=ln if block else None, int8=int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(304, 64, 512), (304, 96, 512), (3, 17, 128),
                                   (4, 72, 640)])
@pytest.mark.parametrize("name,block,int8", WRAPPERS)
@pytest.mark.parametrize("dh", [64, 128])
def test_wrappers_hand_the_kernel_its_operands_and_scratch(monkeypatch, name, block, int8,
                                                           b, s, c, dtype, dh):
    """Each wrapper's C call: x, the key padding, the LayerNorm (block
    bodies), W_in or the cached int8 pair (quant.quantized_weight, the same
    tensors on every call), b_in, W_out, b_out, the prologue's xq (B*S, C)
    int8 and xs (B*S,) float32 (int8 bodies), the (B*S, C) o scratch in x's
    type, the wide-head body's (B*S, 3C) qkv scratch in x's type at a head
    above 64 (else None, a null pointer), out (and x_norm); then B, S, C, H, the
    type and the stream; one count a call."""
    calls, seen = [], []
    _fake_library(monkeypatch, calls)
    real = tattn.mha_scratch

    def scratch(t, q, h):
        bufs = real(t, q, h)
        seen.append(bufs)
        return bufs

    monkeypatch.setattr(tattn, "mha_scratch", scratch)
    x, ln, w = _wrapper_args(b, s, c, dtype)
    h = c // dh
    got = _call(name, block, int8, x, ln, w, h)
    outs = got if block else (got,)
    assert all(o.shape == x.shape and o.dtype == x.dtype for o in outs)
    ((fn, args),) = calls
    assert fn == f"{name}_forward"
    n_ptrs = 2 + 2 * block + (2 if int8 else 1) + 3 + (4 if int8 else 2) + len(outs)
    assert len(args) == n_ptrs + 6
    assert args[n_ptrs:n_ptrs + 5] == (b, s, c, h, 1 if dtype == torch.bfloat16 else 0)
    assert args[0] == x.data_ptr()
    if block:
        assert args[2:4] == (ln["ln_w"].data_ptr(), ln["ln_b"].data_ptr())
    wi = 2 + 2 * block
    if int8:
        q, sc = quant.quantized_weight(w[0])
        assert q.dtype == torch.int8 and sc.dtype == torch.float32
        assert args[wi:wi + 2] == (q.data_ptr(), sc.data_ptr())
        _call(name, block, int8, x, ln, w, h)  # the pair is cached: the same tensors again
        assert calls[1][1][wi:wi + 2] == args[wi:wi + 2]
    else:
        assert args[wi] == w[0].data_ptr()
    (bufs, *_) = seen
    if int8:
        xq, xs, attn, qkv = bufs
        assert xq.shape == (b * s, c) and xq.dtype == torch.int8 and xq.is_contiguous()
        assert xs.shape == (b * s,) and xs.dtype == torch.float32
    else:
        attn, qkv = bufs
    assert attn.shape == (b * s, c) and attn.dtype == dtype
    if dh > 64:
        assert qkv.shape == (b * s, 3 * c) and qkv.dtype == dtype and qkv.is_contiguous()
    else:
        assert qkv is None
    first = wi + (2 if int8 else 1) + 3
    assert args[first:first + len(bufs)] == tuple(None if t is None else t.data_ptr()
                                                  for t in bufs)
    assert args[first + len(bufs):n_ptrs] == tuple(o.data_ptr() for o in outs)
    assert _kernels.LAUNCHES[name] == (2 if int8 else 1)


def _offset(t):
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("name,block,int8", WRAPPERS)
def test_wrappers_refuse_an_unaligned_operand(monkeypatch, name, block, int8):
    """In bfloat16 and float32 alike an offset view of W_out (every body:
    the out-projection copies it by 16-byte cp.async), of W_in (the exact
    bodies' tile copies it) or of x (fused MHA's tile copies it; the block
    bodies' out-projection reads it, the residual, as pairs) raises
    ValueError before any launch; the int8 bodies' tile copies only the
    fresh int8 W_in and xq (their float32 body reads them plainly), and the
    int8 MHA reads x value by value, so those take any offset."""
    calls = []
    _fake_library(monkeypatch, calls)
    for dtype in (torch.bfloat16, torch.float32):
        x, ln, (wi, bi, wo, bo) = _wrapper_args(2, 64, 128, dtype)
        with pytest.raises(ValueError, match="w_out must start on a 16-byte boundary"):
            _call(name, block, int8, x, ln, [wi, bi, _offset(wo), bo], 2)
        if int8:
            _call(name, block, int8, x, ln, [_offset(wi), bi, wo, bo], 2)
        else:
            with pytest.raises(ValueError, match="w_in must start on a 16-byte boundary"):
                _call(name, block, int8, x, ln, [_offset(wi), bi, wo, bo], 2)
        if name == "fused_mha_int8":
            _call(name, block, int8, _offset(x), ln, [wi, bi, wo, bo], 2)
        else:
            with pytest.raises(ValueError, match="x must start on a 16-byte boundary"):
                _call(name, block, int8, _offset(x), ln, [wi, bi, wo, bo], 2)
    assert len(calls) == {"fused_mha_int8": 4, "block_attn_int8": 2}.get(name, 0)
    # the biases and the LayerNorm are read value by value: any offset serves
    x32, ln32, (wi, bi, wo, bo) = _wrapper_args(2, 64, 128, torch.float32)
    ln32 = {k: _offset(v) for k, v in ln32.items()}
    _call(name, block, int8, x32, ln32, [wi, _offset(bi), wo, _offset(bo)], 2)
