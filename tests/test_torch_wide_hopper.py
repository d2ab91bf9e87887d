"""The wide-head bodies' Hopper designs, held on the CPU: flash at D > 128 as
one thread-block cluster a query (or key) tile, each CTA owning one or more
pairs of 64-column slabs of every operand and the cluster's partial scores
summed in rank order (``csrc/flash_attn.cu`` namespace ``cl``), and the MHA family's
bf16 projections on the wgmma GEMM (``csrc/wgmma_linear.cuh``). The kernels
run only on the card (chip_smoke phases 3, 3c-3e and 7b); here their order
of work is emulated in PyTorch and held against the JAX kernels in interpret
mode and the port's plain versions, and the wrappers' C calls go to a
stand-in library."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.ops import attention as jattn
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops import attention as tattn
from tests.test_torch_mha_family import _product, _prologue
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

SLAB = 64  # head columns a slab (wide_window.cuh kDS)
TILE = 64  # rows a tile, both axes
MAX_CLUSTER = 8  # the portable cluster size


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got).astype(jnp.float32))
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(
        jnp.asarray(want).astype(jnp.float32))
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------- the cluster plan
SLABS = 2  # slabs of a pair (flash_attn.cu cl::kNS)


def _slabs(d):
    return -(-d // SLAB)


def _pairs(d):
    """Pairs of slabs a CTA owns (cl::cta_pairs): one up to D 1024, then the
    fewest that keep a cluster within 8 CTAs."""
    return -(-_slabs(d) // (SLABS * MAX_CLUSTER))


def _ctas(d):
    """CTAs a cluster holds at head size d (cl::cluster_ctas): ceil(D / 128)
    up to D 1024."""
    return -(-_slabs(d) // (SLABS * _pairs(d)))


def _pair_slices(d, rank, p):
    """The column slices of pair p of a rank (cl::pair_col)."""
    c0 = (rank * _pairs(d) + p) * SLABS * SLAB
    return [slice(c, min(c + SLAB, d)) for c in range(c0, min(c0 + SLABS * SLAB, d), SLAB)]


def _rank_slabs(d, pp=0):
    """Rank by rank, the column slices whose partial scores the rank adds in
    pass pp, in its order: its other pairs in turn, then pair pp."""
    order = [*(p for p in range(_pairs(d)) if p != pp), pp]
    return [[sl for p in order for sl in _pair_slices(d, r, p)] for r in range(_ctas(d))]


def _pass_cols(d, pp):
    """The output columns of pass pp: every rank's pair pp."""
    return [c for r in range(_ctas(d)) for sl in _pair_slices(d, r, pp) for c in range(d)[sl]]


@pytest.mark.parametrize("d,ctas,pairs", [
    (136, 2, 1), (192, 2, 1), (256, 2, 1), (264, 3, 1), (512, 4, 1), (520, 5, 1), (1024, 8, 1),
    (1032, 5, 2), (1536, 6, 2), (2048, 8, 2), (2056, 6, 3), (8192, 8, 8)])
def test_cluster_plan(d, ctas, pairs):
    """A pair of slabs a CTA, clusters of ceil(D / 128) CTAs, up to D 1024;
    above it ceil(D / 1024) pairs a CTA and at most 8 CTAs (the portable
    limit), at every head size. Every column lies in exactly one pass of one
    rank, and in every pass each rank's partial spans all of its own slabs
    (a rank's last slabs may lie past D)."""
    assert _ctas(d) == ctas <= MAX_CLUSTER and _pairs(d) == pairs
    cols = sorted(c for pp in range(pairs) for c in _pass_cols(d, pp))
    assert cols == list(range(d))
    for pp in range(pairs):
        spans = [sorted(c for sl in rank for c in range(d)[sl]) for rank in _rank_slabs(d, pp)]
        assert sorted(c for span in spans for c in span) == list(range(d))


def _scores(a, b, d, bf16, pp=0):
    """The cluster's sum, in rank order, of each rank's partial a . b^T over
    its own slabs (accumulated in its order of pass pp): 3xTF32 products in
    float32, or (bf16) exact products of the bf16 values summed in float32.
    Every CTA sums every rank's partial in that order, so every CTA has
    these bits."""
    total = None
    for slabs in _rank_slabs(d, pp):
        part = None
        for sl in slabs:
            x = (a[..., sl].float() @ b[..., sl].float().transpose(-1, -2) if bf16
                 else _product(a[..., sl], b[..., sl]))
            part = x if part is None else part + x
        total = part if total is None else total + part
    return total


def _pv(p, v, bf16):
    """p . v with p rounded to bf16 first (bf16), or in 3xTF32."""
    if bf16:
        return p.to(torch.bfloat16).float() @ v.float()
    return _product(p, v.transpose(-1, -2))


def _by_pass(d, run):
    """The cluster bodies' passes (one a pair a CTA owns) put together:
    run(pp) gives the outputs as pass pp computes them, of which each
    output keeps pass pp's columns; an output with no head axis (lse) is
    pass 0's."""
    outs = None
    for pp in range(_pairs(d)):
        got = run(pp)
        if outs is None:
            outs = [g.clone() for g in got]
        cols = _pass_cols(d, pp)
        for o, g in zip(outs, got):
            if g.dim() == 3:  # (BH, S, D)
                o[..., cols] = g[..., cols]
    return outs


def _fwd_cluster(q, k, v, kpad, d):
    return tuple(_by_pass(d, lambda pp: _fwd_pass(q, k, v, kpad, d, pp)))


def _fwd_pass(q, k, v, kpad, d, pp):
    """flash_fwd_cluster_kernel's order of work in pass pp on (BH, S, D)
    tensors (q pre-scaled): key tiles of 64 in order; the scores as the
    cluster's sum of partials; invalid keys at -inf, the online max m (from
    the finite -1e30) and sum l of the unrounded p; acc = alpha acc + p . v
    (bf16: p rounded); o = acc / l in q's type, lse = m + log l, an empty
    row at 0 and +1e30."""
    bf16 = q.dtype == torch.bfloat16
    bh, sq, _ = q.shape
    b, sk = kpad.shape
    valid = (kpad == 0).repeat_interleave(bh // b, dim=0)[:, None, :]
    m = torch.full((bh, sq, 1), tattn.NEG_INF)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    for k0 in range(0, sk, TILE):
        sl = slice(k0, k0 + TILE)
        sc = torch.where(valid[..., sl], _scores(q, k[:, sl], d, bf16, pp),
                         torch.tensor(-np.inf))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + _pv(p, v[:, sl], bf16)
        m = m_new
    lm = torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(lm), torch.full_like(m, -tattn.NEG_INF))
    return (acc / lm).to(q.dtype), lse[..., 0]


def _dq_cluster(q, k, v, kpad, do, lse, delta, d):
    return _by_pass(d, lambda pp: (_dq_pass(q, k, v, kpad, do, lse, delta, d, pp),))[0]


def _dq_pass(q, k, v, kpad, do, lse, delta, d, pp):
    """flash_dq_cluster_kernel's order of work in pass pp: key tiles of 64 in order, s
    and dp as the cluster's sums of partials, p = exp(s - lse) at valid keys,
    ds = p (dp - delta) in float32, dq += ds . k (bf16: ds rounded)."""
    bf16 = q.dtype == torch.bfloat16
    bh = q.shape[0]
    b, sk = kpad.shape
    valid = (kpad == 0).repeat_interleave(bh // b, dim=0)[:, None, :]
    dq = torch.zeros(q.shape)
    for k0 in range(0, sk, TILE):
        sl = slice(k0, k0 + TILE)
        s = _scores(q, k[:, sl], d, bf16, pp)
        dp = _scores(do, v[:, sl], d, bf16, pp)
        p = torch.where(valid[..., sl], torch.exp(s - lse[..., None]), torch.zeros(()))
        dq = dq + _pv(p * (dp - delta[..., None]), k[:, sl], bf16)
    return dq.to(q.dtype)


def _dkv_cluster(q, k, v, kpad, do, lse, delta, d):
    return tuple(_by_pass(d, lambda pp: _dkv_pass(q, k, v, kpad, do, lse, delta, d, pp)))


def _dkv_pass(q, k, v, kpad, do, lse, delta, d, pp):
    """flash_dkv_cluster_kernel's order of work in pass pp: query tiles of 64 in order,
    s^T and dp^T as the cluster's sums of partials, p^T = exp(s^T - lse) at
    valid keys, ds^T = p^T (dp^T - delta) from the unrounded p; dv += p^T .
    do and dk += ds^T . q (bf16: p^T and ds^T rounded)."""
    bf16 = q.dtype == torch.bfloat16
    bh, sq, _ = q.shape
    b = kpad.shape[0]
    valid = (kpad == 0).repeat_interleave(bh // b, dim=0)[:, :, None]
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, sq, TILE):
        sl = slice(q0, q0 + TILE)
        s = _scores(k, q[:, sl], d, bf16, pp)
        dp = _scores(v, do[:, sl], d, bf16, pp)
        p = torch.where(valid, torch.exp(s - lse[:, None, sl]), torch.zeros(()))
        dv = dv + _pv(p, do[:, sl], bf16)
        dk = dk + _pv(p * (dp - delta[:, None, sl]), q[:, sl], bf16)
    return dk.to(k.dtype), dv.to(v.dtype)


# (b, h, sq, sk, d, pad_tail, empty_row): ragged tiles on both axes, a
# padded key tail and a batch row with no valid key; clusters of 2 (D 136,
# 192, 256) and of 5 (D 520; the last rank's second slab past D, as D 136's;
# D 1032: two pairs a CTA, the last rank's second pair past D)
CLUSTER_CASES = [(2, 2, 70, 77, 136, 13, True), (2, 2, 100, 70, 192, 6, True),
                 (2, 2, 96, 130, 256, 30, True), (2, 2, 96, 77, 520, 13, True),
                 (2, 2, 70, 77, 1032, 13, True)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _flash_inputs(b, h, sq, sk, d, pad_tail, empty_row, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, sk, sk))
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    kpad = np.zeros((b, sk), bool)
    kpad[:, sk - pad_tail:] = True
    if empty_row:
        kpad[0] = True
    return q, k, v, do, kpad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,sq,sk,d,pad_tail,empty_row", CLUSTER_CASES)
def test_cluster_bodies_match_jax_and_plain(b, h, sq, sk, d, pad_tail, empty_row, dtype):
    """The cluster bodies' order of work (forward, dq, dk/dv) against the JAX
    flash_attention (its forward, dq and dk/dv kernels in interpret mode,
    through jax.vjp) and autograd of flash_attention_plain, on the same
    inputs and upstream grad: within 1e-5 of max|JAX| in float32 and 1e-2 in
    bfloat16; the empty batch row gives o = 0, lse = +1e30 and zero
    gradients."""
    q, k, v, do, kpad = _flash_inputs(b, h, sq, sk, d, pad_tail, empty_row, seed=d + sq)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    want_o, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, jnp.asarray(kpad),
                                                                block_q=64, block_k=64),
                          jq, jk, jv)
    want_g = vjp(jdo)
    scale = 1.0 / np.sqrt(d)
    flat = [torch.from_numpy(a).to(dtype).reshape(b * h, -1, d) for a in (q, k, v, do)]
    qs = (flat[0] * scale).to(dtype)  # pre-scaled in q's type, as flash_attention does
    kp = torch.from_numpy(kpad).int()
    o, lse = _fwd_cluster(qs, flat[1], flat[2], kp, d)
    # the backward from the plain forward's lse and delta, as the kernels get them
    po, plse = tattn.flash_attention_plain(qs, flat[1], flat[2], kp)
    delta = (flat[3].float() * po.float()).sum(-1)
    dq = _dq_cluster(qs, flat[1], flat[2], kp, flat[3], plse, delta, d)
    dk, dv = _dkv_cluster(qs, flat[1], flat[2], kp, flat[3], plse, delta, d)
    qq, kk, vv = (x.clone().requires_grad_() for x in (qs, flat[1], flat[2]))
    tattn.flash_attention_plain(qq, kk, vv, kp)[0].backward(flat[3])
    tol = TOL[dtype]
    assert _rel(o, po) <= tol and _rel(o.reshape(b, h, sq, d), want_o) <= tol
    has_key = plse < 1e29
    assert (lse[has_key] - plse[has_key]).abs().max() <= 1e-3
    for name, got, plain, jax_ref, f in (("dq", dq, qq.grad, want_g[0], scale),
                                         ("dk", dk, kk.grad, want_g[1], 1.0),
                                         ("dv", dv, vv.grad, want_g[2], 1.0)):
        assert _rel(got, plain) <= tol, name
        # the JAX gradient is taken at the unscaled q: its dq is ours times the scale
        assert _rel(got.float() * f, np.asarray(jax_ref.astype(jnp.float32)).reshape(
            b * h, -1, d)) <= tol, name
    if empty_row:
        assert not o[:h].float().any() and bool((lse[:h] == np.float32(1e30)).all())
        for got in (dq, dk, dv):
            assert not got[:h].float().any()


def test_cluster_scores_are_the_same_in_every_rank():
    """The rank-order sum is one sequence of float32 additions, so summing
    the partials again in the same order gives the same bits: what each CTA
    of a cluster (D 520: five ranks) computes for itself. Summed in another
    order the scores differ in their last bits, which is why every CTA sums
    in rank order."""
    rng = np.random.RandomState(3)
    a, b = (torch.from_numpy(rng.standard_normal((1, 64, 520)).astype(np.float32))
            for _ in range(2))
    parts = []
    for slabs in _rank_slabs(520):
        part = _product(a[..., slabs[0]], b[..., slabs[0]])
        for sl in slabs[1:]:
            part = part + _product(a[..., sl], b[..., sl])
        parts.append(part)
    first = parts[0] + parts[1] + parts[2] + parts[3] + parts[4]
    again = parts[0] + parts[1] + parts[2] + parts[3] + parts[4]
    assert len(parts) == 5 and torch.equal(first, again)
    assert torch.equal(first, _scores(a, b, 520, False))
    assert not torch.equal(first, parts[4] + parts[3] + parts[2] + parts[1] + parts[0])


# --------------------------------------------------- the wgmma GEMM's order
def _gemm(a, w, bias, res=None, stage=64):
    """linear_wgmma_kernel's epilogue order on bf16 operands: the f32 sum of
    the exact products over K in stages of 64, then + bias, then + res,
    then one rounding to bf16."""
    acc = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], stage):
        acc = acc + a[:, k0:k0 + stage].float() @ w[:, k0:k0 + stage].float().T
    acc = acc + bias.float()
    if res is not None:
        acc = acc + res.float()
    return acc.to(torch.bfloat16)


@pytest.mark.parametrize("m,n,k,res", [(51, 3456, 1152, False), (96, 1024, 1024, True),
                                       (17, 24, 64, True)])
def test_gemm_order_matches_the_plain_version(m, n, k, res):
    """The GEMM's order of work against ``wide_linear_plain`` (one f32
    product, then bias and residual, one rounding) and ``wide_linear`` on
    CPU tensors (which is the plain version): they differ only in the f32
    sum's order, within one bf16 rounding; M and N tails included."""
    rng = np.random.RandomState(m + n)
    bf = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32)).bfloat16()
    a, w, bias = bf(m, k), bf(n, k, scale=k ** -0.5), bf(n, scale=0.1)
    r = bf(m, n) if res else None
    got = _gemm(a, w, bias, r)
    want = tattn.wide_linear_plain(a, w, bias, r)
    assert torch.equal(tattn.wide_linear(a, w, bias, r), want)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _rel(got, want) <= 2 ** -7


def _wide_bf16(a, kpad, w_in, b_in, w_out, b_out, h, res=None):
    """A wide bf16 body in its order of work: qkv by the GEMM (rounded to
    bf16), per (window, head) the slab window kernel in the MHA tile's order
    (scores as the sum over 64-column slabs of exact bf16 products, times
    1/sqrt(Dh), padding keys at -1e30, p / l rounded to bf16 before p . v,
    o rounded), then the out-projection by the GEMM (+ res)."""
    b, s, c = a.shape
    dh = c // h
    qkv = _gemm(a.reshape(b * s, c), w_in, b_in)
    q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2) for t in qkv.chunk(3, -1))
    sc = torch.zeros(b, h, s, s)
    for d0 in range(0, dh, SLAB):
        sl = slice(d0, d0 + SLAB)
        sc = sc + q[..., sl].float() @ k[..., sl].float().transpose(-1, -2)
    sc = sc * np.float32(1.0 / np.sqrt(dh))
    sc = torch.where(kpad[:, None, None, :], torch.tensor(tattn.NEG_INF), sc)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).bfloat16().float()
    o = (p @ v.float()).bfloat16().transpose(1, 2).reshape(b * s, c)
    out = _gemm(o, w_out, b_out, None if res is None else res.reshape(b * s, c))
    return out.reshape(b, s, c)


@pytest.mark.parametrize("dh,c", [(128, 1024), (256, 2048)])
@pytest.mark.parametrize("body", ["mha", "block"])
def test_wide_bf16_bodies_in_wgmma_order_match_jax(body, dh, c):
    """Row 1's and row 7's wide bf16 bodies in their order of work (the
    wgmma GEMM's epilogue order for both projections) against the JAX
    kernels in interpret mode (_fused_mha, fused_block_attn) and the port's
    plain versions, S 32, within 1e-2 of max|ref|."""
    h, s = 8, 32
    rng = np.random.RandomState(dh + len(body))
    n = lambda *sh, scale=1.0: (rng.standard_normal(sh) * scale).astype(np.float32)  # noqa: E731
    x = n(2, s, c)
    kpad = np.zeros((2, s), bool)
    kpad[0, 20:] = True
    g, bb = 1.0 + 0.05 * n(c), 0.05 * n(c)
    wi, bi, wo, bo = n(3 * c, c, scale=c ** -0.5), n(3 * c, scale=0.02), n(c, c, scale=c ** -0.5), \
        n(c, scale=0.02)
    tx, tg, tb, twi, tbi, two, tbo = (torch.from_numpy(t).bfloat16()
                                      for t in (x, g, bb, wi, bi, wo, bo))
    tk = torch.from_numpy(kpad)
    j = lambda t: jnp.asarray(t).astype(jnp.bfloat16)  # noqa: E731
    if body == "mha":
        got = _wide_bf16(tx, tk, twi, tbi, two, tbo, h)
        plain = tattn.mha_plain(tx, tk, twi, tbi, two, tbo, h)
        want = jattn._fused_mha(j(x), jnp.asarray(kpad.astype(np.int32)), j(wi.T), j(bi),
                                j(wo.T), j(bo), h)
    else:
        xn = _prologue(tx, tg, tb)[0].reshape(tx.shape)
        got = _wide_bf16(xn, tk, twi, tbi, two, tbo, h, res=tx)
        plain = tattn.block_attn_plain(tx, tk, tg, tb, twi, tbi, two, tbo, h)[0]
        want, _ = jattn.fused_block_attn(j(x), jnp.asarray(kpad), j(g), j(bb), j(wi.T), j(bi),
                                         j(wo.T), j(bo), h)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    assert _rel(got, plain) <= 1e-2
    assert _rel(got, want) <= 1e-2


# ------------------------------------------- the wrappers, stand-in library
class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the wrappers' checks
    run and a stand-in library takes the call."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _card(t):
    return t.as_subclass(_OnCard)


NAMES = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_cluster", "flash_dq_cluster",
         "flash_dkv_cluster", "fused_mha", "fused_mha_int8", "block_attn", "block_attn_int8",
         "wgmma_linear")


def _stand_in(monkeypatch, rc=0, wgmma=0):
    """The wrappers' C calls go to a stand-in library that records (entry
    point, arguments) and returns ``rc``, and reports ``wgmma`` launches of
    the wgmma GEMM when asked its count (that read is not recorded); the
    counters start at 0, and the plain versions raise if anything falls back
    to them."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            if fn == "wgmma_linear_launches":
                return lambda: wgmma
            return lambda *args: calls.append((fn, args)) or rc

    monkeypatch.setattr(_kernels, "library", lambda name: Lib())
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    for name in NAMES:
        monkeypatch.setitem(_kernels.LAUNCHES, name, 0)

    def no_fallback(*a, **kw):
        raise AssertionError("a plain version ran")

    for fn in ("flash_attention_plain", "wide_linear_plain", "mha_plain", "mha_int8_plain",
               "block_attn_plain", "block_attn_int8_plain"):
        monkeypatch.setattr(tattn, fn, no_fallback)
    return calls


def _flash_args(d, bh=2, sq=8, sk=8):
    q = _card(torch.zeros(bh, sq, d))
    kpad = _card(torch.zeros(1, sk, dtype=torch.int32))
    lse = _card(torch.zeros(bh, sq))
    return q, kpad, lse


@pytest.mark.parametrize("d", [128, 136, 256, 520, 1024, 1032, 2056])
def test_flash_counts_its_cluster_bodies(monkeypatch, d):
    """One launch of each flash wrapper counts under its name, and above a
    head of 128 (the cluster bodies) under ``<name>_cluster`` too; every head
    size reaches the library (above D 1024 too: more pairs a CTA)."""
    calls = _stand_in(monkeypatch)
    q, kpad, lse = _flash_args(d)
    tattn.flash_forward(q, q, q, kpad)
    tattn.flash_dq(q, q, q, kpad, q, lse, lse)
    tattn.flash_dkv(q, q, q, kpad, q, lse, lse)
    assert [c[0] for c in calls] == ["flash_attn_forward", "flash_attn_dq", "flash_attn_dkv"]
    assert all(c[1][-3] == d for c in calls)  # ..., D, dtype, stream
    wide = int(d > 128)
    assert {n: _kernels.LAUNCHES[n] for n in NAMES[:6]} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_fwd_cluster": wide,
        "flash_dq_cluster": wide, "flash_dkv_cluster": wide}


@pytest.mark.parametrize("rc", [720, 1])  # cudaErrorClusterOutOfResources, cudaErrorInvalidValue
def test_a_refused_cluster_launch_raises_with_the_kernel_name(monkeypatch, rc):
    """A non-zero return from a cluster body's launcher (a cluster the card
    cannot place, or a refused shape) raises RuntimeError naming the
    wrapper and the cluster body; nothing is counted and no plain version
    runs."""
    _stand_in(monkeypatch, rc=rc)
    q, kpad, lse = _flash_args(256)
    for name, call in (("flash_fwd", lambda: tattn.flash_forward(q, q, q, kpad)),
                       ("flash_dq", lambda: tattn.flash_dq(q, q, q, kpad, q, lse, lse)),
                       ("flash_dkv", lambda: tattn.flash_dkv(q, q, q, kpad, q, lse, lse))):
        with pytest.raises(RuntimeError, match=f"{name}: the cluster body .*cudaError {rc}"):
            call()
    assert not any(_kernels.LAUNCHES[n] for n in NAMES)


def _mha_call(name, c, h, dtype, int8=False, s=4):
    """One call of an MHA-family wrapper's launch path (``_launch_mha``, as
    the kernel wrappers make it on CUDA tensors) on CPU tensors."""
    x = torch.zeros(2, s, c, dtype=dtype)
    w = (torch.zeros(3 * c, c, dtype=dtype), torch.zeros(3 * c, dtype=dtype),
         torch.zeros(c, c, dtype=dtype), torch.zeros(c, dtype=dtype))
    ln = (dict(ln_w=torch.ones(c, dtype=dtype), ln_b=torch.zeros(c, dtype=dtype))
          if name.startswith("block") else None)
    with torch.no_grad():
        return tattn._launch_mha(name, x, None, *w, h, ln=ln, int8=int8)


@pytest.mark.parametrize("c,h,dtype,want", [
    (1024, 8, torch.bfloat16, 2), (2048, 8, torch.bfloat16, 1), (512, 8, torch.bfloat16, 0),
    (1024, 8, torch.float32, 3)])
def test_mha_family_counts_its_wgmma_projections(monkeypatch, c, h, dtype, want):
    """The MHA family counts under ``wgmma_linear`` the launches that the
    library reports it made in the call (the C side counts the GEMM where it
    launches it: on the card two a call of the exact wide bf16 bodies, one
    of the int8 ones, chip_smoke phases 3 and 7b), whatever the wrapper
    would guess from the shape: here the stand-in reports ``want`` a call."""
    _stand_in(monkeypatch, wgmma=want)
    n = 0
    for name, int8 in (("fused_mha", False), ("fused_mha_int8", True), ("block_attn", False),
                       ("block_attn_int8", True)):
        _mha_call(name, c, h, dtype, int8)
        n += want
        assert _kernels.LAUNCHES["wgmma_linear"] == n, name
        assert _kernels.LAUNCHES[name] == 1


@pytest.mark.parametrize("rc", [801, 1])  # cudaErrorNotSupported (no encoder), InvalidValue
def test_a_failed_tensor_map_raises(monkeypatch, rc):
    """A non-zero return from the GEMM (its tensor-map encode failed, or
    libcuda has no encoder) raises RuntimeError naming the kernel, from
    ``wide_linear`` and from a wide bf16 body; nothing is counted (not even
    a launch the library reports from before the failure) and no plain
    version runs."""
    calls = _stand_in(monkeypatch, rc=rc, wgmma=1)
    a = _card(torch.zeros(8, 64, dtype=torch.bfloat16))
    w = _card(torch.zeros(24, 64, dtype=torch.bfloat16))
    b = _card(torch.zeros(24, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match=f"wgmma_linear: .*cudaError {rc}"):
        tattn.wide_linear(a, w, b)
    assert calls[-1][0] == "wgmma_linear_forward"
    with pytest.raises(RuntimeError, match=f"fused_mha: .*cudaError {rc}"):
        _mha_call("fused_mha", 1024, 8, torch.bfloat16)
    assert not any(_kernels.LAUNCHES[n] for n in NAMES)


def test_wide_linear_checks_before_the_call(monkeypatch):
    """``wide_linear`` takes bf16 (M, K) and (N, K) operands with N and K
    multiples of 8, 16-byte aligned: anything else raises before the
    library is reached."""
    calls = _stand_in(monkeypatch)
    bf = lambda *s: _card(torch.zeros(*s, dtype=torch.bfloat16))  # noqa: E731
    with pytest.raises(ValueError, match="multiples of 8"):
        tattn.wide_linear(bf(8, 60), bf(24, 60), bf(24))
    with pytest.raises(TypeError):
        tattn.wide_linear(_card(torch.zeros(8, 64)), bf(24, 64), bf(24))
    with pytest.raises(ValueError, match="do not fit"):
        tattn.wide_linear(bf(8, 64), bf(24, 32), bf(24))
    assert not calls


def test_wide_linear_counts_what_the_library_launched(monkeypatch):
    """``wide_linear`` counts under ``wgmma_linear`` the launches the library
    reports for the call, not one a call on its own say."""
    calls = _stand_in(monkeypatch, wgmma=1)
    bf = lambda *s: _card(torch.zeros(*s, dtype=torch.bfloat16))  # noqa: E731
    tattn.wide_linear(bf(8, 64), bf(24, 64), bf(24))
    assert [c[0] for c in calls] == ["wgmma_linear_forward"]
    assert _kernels.LAUNCHES["wgmma_linear"] == 1
    _stand_in(monkeypatch, wgmma=0)
    tattn.wide_linear(bf(8, 64), bf(24, 64), bf(24))
    assert _kernels.LAUNCHES["wgmma_linear"] == 0
