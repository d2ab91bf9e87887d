"""The wide window kernel's ring design and the wide float32 bodies' wgmma
GEMM, held on the CPU.

The window kernel (``csrc/wide_window.cuh``: a ring of stages of two tiles
of 128 bytes of columns, kept in flight by cp.async, the scores summed over
the tiles, the softmax once, o two tiles of v's columns a step) and the
3xTF32 wgmma GEMM of the MHA family's wide float32 bodies
(``csrc/wgmma_linear.cuh``) run only on the card (chip_smoke phases 3,
3d-3f and 7b). Here their order of work is emulated in PyTorch and held
against the JAX kernels (the window core's ``small_attention``, the fused
MHA's ``fused_mha_small`` and ``fused_block_attn``, in interpret mode) and
the port's plain versions; the wrappers' C calls go to a stand-in library.

Tolerances (max error / max|reference|): float32 1e-5 (3xTF32 keeps float32
accuracy: the sums' order over D and C is what is left), bfloat16 1e-2 (the
bf16 roundings of q, k, v and p). A fully-masked window is held against the
plain version, which averages the window's own values (the JAX kernel
averages its packed tile there: tests/test_torch_small.py pins that).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.ops import attention as jattn
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops import attention as tattn
from tests.test_torch_mha_family import _prologue
from tests.test_torch_mlp_family import _tf32
from tests.test_torch_wide_hopper import _card, _gemm
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

NS = 2  # stages of the ring (wide_window.cuh kWindowStages)
SMEM_SM = 228 * 1024  # an H100 SM's shared memory; a CTA reserves 1 KB of it
WIDTH = {torch.float32: 32, torch.bfloat16: 64}  # columns a tile: 128 bytes
PITCH = {torch.float32: 36, torch.bfloat16: 72}  # a tile's row pitch, elements


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got).astype(jnp.float32))
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(
        jnp.asarray(want).astype(jnp.float32))
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------------ the ring plan
def _steps(d, dtype):
    """The ring's steps at head size d, in order: ('qk', columns) for q's and
    k's tiles, then ('v', [columns of its tiles]) two tiles of v a step."""
    w = WIDTH[dtype]
    tiles = [range(d0, min(d0 + w, d)) for d0 in range(0, d, w)]
    return [("qk", t) for t in tiles] + [("v", tiles[i:i + 2]) for i in range(0, len(tiles), 2)]


def _smem(s, dtype):
    """window_smem<T, NS>: the ring and the key flags."""
    sp = -(-s // 16) * 16
    return NS * 2 * sp * PITCH[dtype] * dtype.itemsize + sp * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 128, 136, 256, 520, 2056])
def test_ring_plan(d, dtype):
    """Every column of q and k lies in exactly one score step and every
    column of v in exactly one v step, in order; a tile is 128 bytes of a
    row (16-byte copies, 8 a row); at S 128 three windows fit an SM's
    shared memory at any head size (the ring does not grow with D; the 128
    registers a thread hold it to two), at S 64 six."""
    steps = _steps(d, dtype)
    qk = [c for kind, t in steps if kind == "qk" for c in t]
    v = [c for kind, ts in steps if kind == "v" for t in ts for c in t]
    assert qk == v == list(range(d))
    assert all(len(ts) <= 2 for kind, ts in steps if kind == "v")
    assert WIDTH[dtype] * dtype.itemsize == 128
    # the pitch keeps fragment reads conflict-free: f32 4 (mod 8) words, bf16
    # rows 16 bytes apart (mod 128) for ldmatrix
    assert PITCH[dtype] * dtype.itemsize % 128 == 16
    assert 3 * (_smem(128, dtype) + 1024) <= SMEM_SM
    assert 6 * (_smem(64, dtype) + 1024) <= SMEM_SM


# ------------------------------------------------ the window kernel's order
def _tiles(d, dtype):
    w = WIDTH[dtype]
    return [slice(d0, min(d0 + w, d)) for d0 in range(0, d, w)]


def _prod(a, b):
    """a . b^T as the kernel's products compute it: bf16 operands exactly in
    float32, float32 operands in 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi)."""
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float().transpose(-1, -2)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    t = lambda x: x.transpose(-1, -2)  # noqa: E731
    return al @ t(bh) + ah @ t(bl) + ah @ t(bh)


def _window(q, k, v, kpad, small):
    """window_kernel's order of work on (B, H, S, D) q, k, v of one type:
    SMALL (small=True) q taken to T(float(q) * scale) first; the scores
    summed over the ring's score steps (tiles of 128 bytes of columns); the
    MHA order times scale after; padding keys at -1e30; p = exp(s - max), l
    = sum p in float32; o over v's tiles: SMALL (p rounded to bf16 in bf16)
    . v, then / l; MHA (p / l, rounded in bf16) . v; o in T."""
    dtype, d = q.dtype, q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(d))
    if small:
        q = (q.float() * scale).to(dtype)
    s = None
    for sl in _tiles(d, dtype):
        part = _prod(q[..., sl], k[..., sl])
        s = part if s is None else s + part
    if not small:
        s = s * scale
    s = torch.where(kpad.bool()[:, None, None, :], torch.tensor(tattn.NEG_INF), s)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p = p if small else p / l
    if dtype == torch.bfloat16:
        p = p.to(torch.bfloat16)
    o = torch.cat([_prod(p, v[..., sl].transpose(-1, -2)) for sl in _tiles(d, dtype)], -1)
    return (o / l if small else o).to(dtype)


def _qkv(b, h, s, d, seed, dtype, masked=False):
    """q, k, v as the views of a packed (B, S, 3HD) qkv (grounding's layout),
    ragged key lengths, window 0 fully masked with ``masked``."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)).to(dtype)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, -1))
    lens = rng.randint(max(1, s // 2), s + 1, b)
    if masked:
        lens[0] = 0
    return q, k, v, torch.from_numpy(np.arange(s)[None, :] >= lens[:, None])


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [17, 100])
@pytest.mark.parametrize("d", [128, 136, 256, 520])
def test_window_core_order_matches_jax_and_plain(d, s, dtype):
    """The window core's order (SMALL) at D 128 (which small_attn.cu sends to
    the window kernel too), 136, 256 and 520 (2 to 17 score steps), S 17
    and 100, ragged lengths, against the JAX
    small_attention in interpret mode and the port's small_attention on CPU
    tensors (its plain version): f32 within 1e-5 of max|ref|, bf16 1e-2."""
    q, k, v, kpad = _qkv(2, 2, s, d, d + s, dtype)
    got = _window(q, k, v, kpad, small=True)
    want = jattn.small_attention(_j(q), _j(k), _j(v), jnp.asarray(kpad.numpy()))
    plain = tattn.small_attention(q, k, v, kpad)
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(got, plain) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("small", [True, False])
def test_fully_masked_window_averages_its_own_values(small, dtype):
    """A window whose keys are all padding: every key at -1e30, so p is 1 on
    the window's S keys and o their mean, in both orders, as the plain
    versions answer (S 100, D 256)."""
    q, k, v, kpad = _qkv(2, 2, 100, 256, 7, dtype, masked=True)
    got = _window(q, k, v, kpad, small=small)
    if small:
        plain = tattn.small_attention(q, k, v, kpad)
    else:
        plain = tattn.attention_plain(q, k, v, kpad, scale=1.0 / 16.0)
    assert _rel(got, plain) <= TOL[dtype]
    mean = v[0].float().mean(-2, keepdim=True).expand(2, 100, 256)
    assert _rel(got[0], mean) <= TOL[dtype]


# ----------------------------------------------- the f32 wgmma GEMM's order
def _gemm_tf32(a, w, bias, res=None, terms=3):
    """linear_tf32_wgmma_kernel's order on float32: per stage of 32 of K a
    fresh sum, k-step by k-step of 8: d = a_lo w_hi, d += a_hi w_lo, d +=
    a_hi w_hi (hi the bit mask, lo = x - hi, read as TF32; each product
    exact in float32); the stage's sum added to the f32 sum; then + bias,
    then + res. ``terms=1``: a_hi w_hi alone (plain TF32)."""
    acc = torch.zeros(a.shape[0], w.shape[0])
    for s0 in range(0, a.shape[1], 32):
        d = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + 32, a.shape[1]), 8):
            ak, wk = a[:, k0:k0 + 8], w[:, k0:k0 + 8]
            ah, wh = _tf32(ak), _tf32(wk)
            if terms == 3:
                d = d + _tf32(ak - ah) @ wh.T
                d = d + ah @ _tf32(wk - wh).T
            d = d + ah @ wh.T
        acc = acc + d
    acc = acc + bias
    return acc if res is None else acc + res


@pytest.mark.parametrize("m,n,k,res", [(51, 3456, 1152, False), (96, 1024, 1024, True),
                                       (17, 24, 72, True), (130, 2056, 264, False)])
def test_tf32_gemm_order_matches_the_plain_version(m, n, k, res):
    """The f32 GEMM's order of work against ``wide_linear_plain`` (one f32
    product, then bias and residual) and ``wide_linear`` on CPU tensors
    (which is the plain version), within 1e-5 of max|ref|, M, N and K tails
    included (not multiples of the 128 x BN x 32 tile); plain TF32 misses
    the bar."""
    rng = np.random.RandomState(m + n + k)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32))
    a, w, bias = f(m, k), f(n, k, scale=k ** -0.5), f(n, scale=0.1)
    r = f(m, n) if res else None
    want = tattn.wide_linear_plain(a, w, bias, r)
    assert torch.equal(tattn.wide_linear(a, w, bias, r), want)
    assert want.dtype == torch.float32
    assert _rel(_gemm_tf32(a, w, bias, r), want) <= 1e-5
    assert _rel(_gemm_tf32(a, w, bias, r, terms=1), want) > 1e-5


def test_tf32_split_is_exact():
    """hi (the bit mask) + lo = x exactly, for every float32 the GEMM may
    read (normal, subnormal, zero, the extremes), and |lo| < 2^-10 |x| for a
    normal x: hi keeps TF32's 10 mantissa bits, so a_lo b_lo, the term
    3xTF32 drops, is below 2^-20 of a product."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.randint(
        -30, 30, 4096), np.array([0.0, -0.0, 1e-40, -3e-39, 3.4e38, -3.4e38, 1.0], np.float32)])
    t = torch.from_numpy(x.astype(np.float32))
    hi = _tf32(t)
    lo = t - hi
    assert torch.equal(hi + lo, t)
    normal = t.abs() >= 2.0 ** -126
    assert normal.sum() > 4000 and (lo.abs() < t.abs() * 2 ** -10)[normal].all()


# ------------------------------- the wide f32 bodies in their order of work
def _wide_body(a, kpad, w_in, b_in, w_out, b_out, h, res=None):
    """A wide body of rows 1 and 7 in its order of work: qkv by the GEMM
    (f32: the wgmma 3xTF32 order; bf16: the bf16 GEMM, rounded), per
    (window, head) the window kernel in the MHA order, o in T, then the
    out-projection by the GEMM (+ res)."""
    b, s, c = a.shape
    dh = c // h
    gemm = _gemm_tf32 if a.dtype == torch.float32 else _gemm
    qkv = gemm(a.reshape(b * s, c), w_in, b_in).to(a.dtype)
    q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2) for t in qkv.chunk(3, -1))
    o = _window(q, k, v, kpad, small=False).transpose(1, 2).reshape(b * s, c)
    out = gemm(o, w_out, b_out, None if res is None else res.reshape(b * s, c))
    return out.to(a.dtype).reshape(b, s, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,c", [(128, 1024), (256, 2048)])
@pytest.mark.parametrize("body", ["mha", "block"])
def test_wide_bodies_in_their_order_match_jax(body, dh, c, dtype):
    """Rows 1 and 7's wide bodies in their order of work (the wgmma GEMMs'
    orders for both projections, the window kernel in the MHA order between
    them) against the JAX kernels in interpret mode (fused_mha_small,
    fused_block_attn) and the port's plain versions, S 32, ragged lengths:
    f32 within 1e-5 of max|ref|, bf16 1e-2."""
    h, s = 8, 32
    rng = np.random.RandomState(dh + len(body))
    n = lambda *sh, scale=1.0: (rng.standard_normal(sh) * scale).astype(np.float32)  # noqa: E731
    x = n(2, s, c)
    kpad = np.zeros((2, s), bool)
    kpad[0, 20:] = True
    g, bb = 1.0 + 0.05 * n(c), 0.05 * n(c)
    wi, bi, wo, bo = n(3 * c, c, scale=c ** -0.5), n(3 * c, scale=0.02), n(c, c, scale=c ** -0.5), \
        n(c, scale=0.02)
    tx, tg, tb, twi, tbi, two, tbo = (torch.from_numpy(t).to(dtype)
                                      for t in (x, g, bb, wi, bi, wo, bo))
    tk = torch.from_numpy(kpad)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda t: jnp.asarray(t).astype(jd)  # noqa: E731
    if body == "mha":
        got = _wide_body(tx, tk, twi, tbi, two, tbo, h)
        plain = tattn.mha_plain(tx, tk, twi, tbi, two, tbo, h)
        want = jattn.fused_mha_small(j(x), jnp.asarray(kpad.astype(np.int32)), j(wi.T), j(bi),
                                     j(wo.T), j(bo), h)
    else:
        xn = _prologue(tx, tg, tb)[0].reshape(tx.shape)
        got = _wide_body(xn, tk, twi, tbi, two, tbo, h, res=tx)
        plain = tattn.block_attn_plain(tx, tk, tg, tb, twi, tbi, two, tbo, h)[0]
        want, _ = jattn.fused_block_attn(j(x), jnp.asarray(kpad), j(g), j(bb), j(wi.T), j(bi),
                                         j(wo.T), j(bo), h)
    assert got.dtype == dtype and got.shape == tx.shape
    assert _rel(got, plain) <= TOL[dtype]
    assert _rel(got, want) <= TOL[dtype]


# ------------------------------------------- the wrappers, stand-in library
NAMES = ("small_attn", "fused_mha", "fused_mha_int8", "block_attn", "block_attn_int8",
         "wgmma_linear", "wgmma_linear_tf32", "wide_window")


def _stand_in(monkeypatch, rc=0, **reported):
    """The wrappers' C calls go to a stand-in library that records (entry
    point, arguments) and returns ``rc``; asked a body's count
    (BODY_COUNTERS), it reports ``reported[name]`` (0 if not given), and
    that read is not recorded. The counters start at 0 and the plain
    versions raise if anything falls back to them."""
    calls = []
    readers = {fn: name for name, fn in _kernels.BODY_COUNTERS.items()}

    class Lib:
        def __getattr__(self, fn):
            if fn in readers:
                return lambda: reported.get(readers[fn], 0)
            return lambda *args: calls.append((fn, args)) or rc

    monkeypatch.setattr(_kernels, "library", lambda name: Lib())
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    for name in NAMES:
        monkeypatch.setitem(_kernels.LAUNCHES, name, 0)

    def no_fallback(*a, **kw):
        raise AssertionError("a plain version ran")

    for fn in ("small_attention_plain", "wide_linear_plain", "mha_plain", "mha_int8_plain",
               "block_attn_plain", "block_attn_int8_plain"):
        monkeypatch.setattr(tattn, fn, no_fallback)
    return calls


def _meta_window(d, s=16):
    """q, k, v (B2 H2 S D) on the meta device (a card's tensor to the
    wrapper's checks) and a bool key padding."""
    q = torch.empty(2, 2, s, d, device="meta")
    return q, q, q, torch.zeros(2, s, dtype=torch.bool, device="meta")


@pytest.mark.parametrize("d,wide", [(64, 0), (120, 0), (128, 1), (136, 1), (256, 1), (520, 1)])
def test_small_attention_counts_the_window_kernel(monkeypatch, d, wide):
    """One small_attention call counts one small_attn launch and, under
    ``wide_window``, the window kernel's launches that the library reports
    (the C side counts them where it launches: one a call at D 128 and
    above, MAX_SMALL_TILE_D the fixed tiles' largest head), whatever the
    wrapper would guess from the head size."""
    assert tattn.MAX_SMALL_TILE_D == 120
    calls = _stand_in(monkeypatch, wide_window=wide)
    with torch.no_grad():
        o = tattn.small_attention(*_meta_window(d))
    assert o.shape == (2, 2, 16, d)
    ((fn, args),) = calls
    assert fn == "small_attn_forward" and args[5:9] == (2, 2, 16, d)
    assert _kernels.LAUNCHES["small_attn"] == 1
    assert _kernels.LAUNCHES["wide_window"] == wide


@pytest.mark.parametrize("rc", [1, 2, 98])  # InvalidValue, MemoryAllocation, InvalidDeviceFunction
def test_a_refused_window_launch_raises_with_the_kernel_name(monkeypatch, rc):
    """A non-zero return from small_attn_forward at a wide head (the window
    kernel refused: too much shared memory, a bad shape) raises
    RuntimeError naming the wrapper; nothing is counted, not even a launch
    the library reports, and no plain version runs."""
    _stand_in(monkeypatch, rc=rc, wide_window=1)
    with torch.no_grad(), pytest.raises(RuntimeError, match=f"small_attn: .*cudaError {rc}"):
        tattn.small_attention(*_meta_window(256))
    assert not any(_kernels.LAUNCHES[n] for n in NAMES)


def _mha_call(name, c, h, dtype, int8=False, s=4):
    """One call of an MHA-family wrapper's launch path (``_launch_mha``)."""
    x = torch.zeros(2, s, c, dtype=dtype)
    w = (torch.zeros(3 * c, c, dtype=dtype), torch.zeros(3 * c, dtype=dtype),
         torch.zeros(c, c, dtype=dtype), torch.zeros(c, dtype=dtype))
    ln = (dict(ln_w=torch.ones(c, dtype=dtype), ln_b=torch.zeros(c, dtype=dtype))
          if name.startswith("block") else None)
    with torch.no_grad():
        return tattn._launch_mha(name, x, None, *w, h, ln=ln, int8=int8)


MHA_FAMILY = (("fused_mha", False), ("fused_mha_int8", True), ("block_attn", False),
              ("block_attn_int8", True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_family_counts_its_f32_gemm_and_window(monkeypatch, dtype):
    """The MHA family counts under ``wgmma_linear_tf32`` and ``wide_window``
    what the library reports it launched in the call (on the card, C 1024 H
    8 in f32: two f32 GEMMs an exact call, one an int8 call, and one window
    kernel each, chip_smoke's check_wgmma_launches): here the stand-in
    reports the design's counts for the body called."""
    for name, int8 in MHA_FAMILY:
        f32 = dtype == torch.float32
        gemms = 1 if int8 else 2
        _stand_in(monkeypatch, wgmma_linear=0 if f32 else gemms,
                  wgmma_linear_tf32=gemms if f32 else 0, wide_window=1)
        _mha_call(name, 1024, 8, dtype, int8)
        assert {n: _kernels.LAUNCHES[n] for n in NAMES if _kernels.LAUNCHES[n]} == {
            name: 1, "wgmma_linear_tf32" if f32 else "wgmma_linear": gemms, "wide_window": 1}


@pytest.mark.parametrize("rc", [801, 1])  # cudaErrorNotSupported (no encoder), InvalidValue
def test_a_failed_f32_tensor_map_raises(monkeypatch, rc):
    """A non-zero return from the f32 GEMM (its tensor-map encode failed, or
    libcuda has no encoder) raises RuntimeError naming the kernel, from
    ``wide_linear`` on float32 and from every wide f32 body of the family;
    nothing is counted and no plain version runs."""
    calls = _stand_in(monkeypatch, rc=rc, wgmma_linear_tf32=1, wide_window=1)
    a, w, b = _card(torch.zeros(8, 64)), _card(torch.zeros(24, 64)), _card(torch.zeros(24))
    with pytest.raises(RuntimeError, match=f"wgmma_linear_tf32: .*cudaError {rc}"):
        tattn.wide_linear(a, w, b)
    assert calls[-1][0] == "wgmma_linear_tf32_forward"
    for name, int8 in MHA_FAMILY:
        with pytest.raises(RuntimeError, match=f"{name}: .*cudaError {rc}"):
            _mha_call(name, 1024, 8, torch.float32, int8)
        assert calls[-1][0] == f"{name}_forward"
    assert not any(_kernels.LAUNCHES[n] for n in NAMES)


def test_wide_linear_f32_checks_and_counts(monkeypatch):
    """``wide_linear`` on float32 takes float32 (M, K) and (N, K) operands
    with N and K multiples of 8 (anything else raises before the library is
    reached), calls ``wgmma_linear_tf32_forward`` and counts under
    ``wgmma_linear_tf32`` the launches the library reports."""
    calls = _stand_in(monkeypatch, wgmma_linear_tf32=1)
    f = lambda *s: _card(torch.zeros(*s))  # noqa: E731
    with pytest.raises(ValueError, match="multiples of 8"):
        tattn.wide_linear(f(8, 60), f(24, 60), f(24))
    with pytest.raises(TypeError):
        tattn.wide_linear(f(8, 64), _card(torch.zeros(24, 64, dtype=torch.bfloat16)), f(24))
    assert not calls
    y = tattn.wide_linear(f(8, 64), f(24, 64), f(24), f(8, 24))
    assert y.shape == (8, 24) and y.dtype == torch.float32
    ((fn, args),) = calls
    assert fn == "wgmma_linear_tf32_forward" and args[3] is not None and args[5:8] == (8, 24, 64)
    assert _kernels.LAUNCHES["wgmma_linear_tf32"] == 1
    assert _kernels.LAUNCHES["wgmma_linear"] == 0
