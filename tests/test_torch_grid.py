"""The MIL-NCE grid kernel (csrc/milnce_grid.cu) checked on the CPU.

The CUDA kernels run only on the card (chip_smoke.py phase 3b holds them
against ``grid_lse2_plain`` there). Here their order of work is emulated on
the same inputs and held against the JAX Pallas kernel in interpret mode (its
values and its VJP through ``jax.vjp``, as tests/test_torch_losses.py runs it)
and against ``grid_lse2_plain`` with autograd:
  * the forward: 64-row blocks, the 64-column walk split in two halves of
    the column tiles, the depth in K chunks (64 floats, 128 bf16 values),
    the online row max / sum-exp of each 32-column half of a tile combined
    at the end of a split, per-column (max, sum-exp) over each 16-row warp
    and then over the block, the column partials reduced in row-block order
    and the row partials in split order;
  * the dv and dt kernels: z over the depth panels in the order that ends with
    the output slab's own, dz rounded to bfloat16 in bfloat16, the second
    product per walked tile, dt's split partials summed in split order;
  * float32 products in 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi); plain
    TF32 (a_hi b_hi) is at least ten times further from float64.
Beside them: the wrappers refuse an operand the kernels copy by 16-byte
cp.async at an offset view, before any launch, and the dt kernel's splits
cover its work list exactly once.

Tolerances, max error / max|reference|: float32 1e-4 (summation order:
chunked sums, the online statistics, 3xTF32 drops a_lo b_lo), bfloat16 1e-2
(dz rounded to bfloat16 where the plain version keeps float32; bfloat16
outputs); chip_smoke's limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.ops import milnce_grid as jgrid
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops import milnce_grid as tgrid
from exoground_tpu_torch.ops.milnce_grid import NEG_FILL, grid_lse2_plain
from tests.test_torch_mlp_family import _tf32
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TILE, PANEL, COL_SPLITS = 64, 512, 2  # kTile, kPanel, kColSplits in csrc/milnce_grid.cu
# K chunks (Lay<T>): the forward's; the backward's over one panel and over several
KF = {torch.float32: 64, torch.bfloat16: 128}
KB = {torch.float32: 128, torch.bfloat16: 256}
KM = {torch.float32: 64, torch.bfloat16: 128}
INV = 1.0 / 0.07
INF = float("inf")


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(s, st, r, cc, c, n_invalid, seed):
    rng = np.random.RandomState(seed)
    v, t = _unit(rng, s, r, c), _unit(rng, st, cc, c)
    valid = np.ones(cc, bool)
    valid[rng.choice(cc, n_invalid, replace=False)] = False
    gv = rng.standard_normal((s, r)).astype(np.float32)
    gt = rng.standard_normal((s, cc)).astype(np.float32)
    return v, t, valid, gv, gt


def _prod(a, b, terms=3):
    """a . b^T as the tensor cores compute it: bfloat16 operands exactly in
    float32 with float32 sums; float32 operands in 3xTF32 (terms 1: a_hi
    b_hi alone, plain TF32)."""
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float().T
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh.T
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def _pad(x, r0, n=TILE):
    """Rows r0.. r0 + n of x, zero past its end (cp.async's zero-fill)."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype)
    part = x[r0:r0 + n]
    out[:len(part)] = part
    return out


def _z(a, b, c, kc, n0, terms):
    """z = a . b^T over the depth in K chunks, the panels in the order that
    ends with the panel of output column n0."""
    npan, ps = -(-c // PANEL), n0 // PANEL
    z = torch.zeros(a.shape[0], b.shape[0])
    for i in range(1, npan + 1):
        p = (ps + i) % npan
        for k0 in range(p * PANEL, min(c, (p + 1) * PANEL), kc):
            z = z + _prod(a[:, k0:k0 + kc], b[:, k0:k0 + kc], terms)
    return z


# ------------------------------------------------------------ the forward
def _emulate_forward(v, t, valid, inv, terms=3):
    s_n, r, c = v.shape
    st, cc, _ = t.shape
    nr, nt = -(-r // TILE), -(-cc // TILE)
    ncs = COL_SPLITS if nt > 1 else 1
    pm, pl = torch.empty(s_n, nr, cc), torch.empty(s_n, nr, cc)
    rm, rl = torch.empty(ncs, s_n, r), torch.empty(ncs, s_n, r)
    cvalid = torch.from_numpy(valid)
    for s in range(s_n):
        ts = t[0 if st == 1 else s]
        for rb, cs in [(rb, cs) for rb in range(nr) for cs in range(ncs)]:
            r0 = rb * TILE
            a = _pad(v[s], r0)
            rin = torch.arange(r0, r0 + TILE) < r
            m, l = torch.full((2, TILE), -1e30), torch.zeros(2, TILE)  # per column half
            for j in range(cs * nt // ncs, (cs + 1) * nt // ncs):
                z = _z(a, _pad(ts, j * TILE), c, KF[v.dtype], 0, terms)
                cols = torch.arange(j * TILE, (j + 1) * TILE)
                cin = cols < cc
                cv = cin & _pad(cvalid, j * TILE)
                z = torch.where(cin, torch.where(cv, z * inv, NEG_FILL), -INF)
                for h in range(2):  # the online row statistics of warps wc = 0, 1
                    zh = z[:, 32 * h:32 * h + 32]
                    m_new = torch.maximum(m[h], zh.max(1).values)
                    l[h] = l[h] * torch.exp(m[h] - m_new) + torch.exp(zh - m_new[:, None]).sum(1)
                    m[h] = m_new
                zc = torch.where(rin[:, None], z, -INF).view(4, 16, TILE)  # 16-row warps
                cm = zc.max(1).values
                cs_ = torch.where(cm[:, None] > -INF, torch.exp(zc - cm[:, None]), 0.0).sum(1)
                mm = cm.max(0).values
                ll = torch.where(cm > -INF, cs_ * torch.exp(cm - mm), 0.0).sum(0)
                pm[s, rb, cols[cin]], pl[s, rb, cols[cin]] = mm[cin], ll[cin]
            mm = torch.maximum(m[0], m[1])
            n = min(TILE, r - r0)
            rm[cs, s, r0:r0 + n] = mm[:n]
            rl[cs, s, r0:r0 + n] = (l[0] * torch.exp(m[0] - mm) + l[1] * torch.exp(m[1] - mm))[:n]
    return _lse_in_order(rm, rl), _lse_in_order(pm.transpose(0, 1), pl.transpose(0, 1))


def _lse_in_order(pm, pl):
    """grid_lse_reduce_kernel: logsumexp of partials along the first axis,
    summed in order."""
    m = pm.max(0).values
    total = torch.zeros_like(m)
    for i in range(len(pm)):
        total = total + pl[i] * torch.exp(pm[i] - m)
    return m + torch.log(total.clamp_min(1e-30))


# ----------------------------------------------------------- the backward
def _dz(z, vid, txt, inv):
    """dz of z values from the video side (v_den, g_v, in range) and the text
    side (t_den, g_t, in range, valid), in the TPU body's order."""
    vd, gv, vin = vid
    td, gt, tin, tv = txt
    zz = torch.where(tv, z * inv, NEG_FILL)
    pr = torch.exp(zz - vd)
    pc = torch.where(tv, torch.exp(zz - td), 0.0)
    return torch.where(vin & tin, (pr * gv + pc * gt) * inv, 0.0)


def _second(dz, bt, dtype, terms):
    """The second product dz (64 x 64) . bt (64 x n): dz rounded to bfloat16
    in bfloat16 (the TPU kernel's cast)."""
    if dtype == torch.bfloat16:
        return dz.to(torch.bfloat16).float() @ bt.float()
    return _prod(dz, bt.T.contiguous(), terms)


def _emulate_backward(v, t, valid, vden, tden, gv, gt, inv, nsplit, terms=3):
    s_n, r, c = v.shape
    st, cc, _ = t.shape
    dtype, ns = v.dtype, tgrid.bwd_slab(c, v.dtype)
    kc = KM[dtype] if c > PANEL else KB[dtype] if c % KB[dtype] == 0 else 128
    cvalid = torch.from_numpy(valid)
    nrb = -(-r // TILE)

    def video_side(s, r0):  # (64,) values of rows r0..
        idx = torch.arange(r0, r0 + TILE)
        return _pad(vden[s], r0), _pad(gv[s], r0), idx < r

    def text_side(s, c0):
        idx = torch.arange(c0, c0 + TILE)
        return (_pad(tden[s], c0), _pad(gt[s], c0), idx < cc,
                (idx < cc) & _pad(cvalid, c0))

    dv = torch.zeros(s_n, r, c)
    for s in range(s_n):  # grid_bwd_kernel<T, NS, false>
        ts = t[0 if st == 1 else s]
        for rb in range(nrb):
            a = _pad(v[s], rb * TILE)
            vd, g, vin = video_side(s, rb * TILE)
            for n0 in range(0, c, ns):
                nw = min(ns, c - n0)
                acc = torch.zeros(TILE, nw)
                for j in range(-(-cc // TILE)):
                    b = _pad(ts, j * TILE)
                    td, g2, tin, tv = text_side(s, j * TILE)
                    dz = _dz(_z(a, b, c, kc, n0, terms), (vd[:, None], g[:, None], vin[:, None]),
                             (td[None], g2[None], tin[None], tv[None]), inv)
                    acc = acc + _second(dz, b[:, n0:n0 + nw], dtype, terms)
                n = min(TILE, r - rb * TILE)
                dv[s, rb * TILE:rb * TILE + n, n0:n0 + nw] = acc[:n]

    items = (s_n if st == 1 else 1) * nrb
    dt = torch.zeros(st, cc, c)
    for so in range(st):  # grid_bwd_kernel<T, NS, true>, then grid_dt_sum_kernel
        for cb in range(-(-cc // TILE)):
            a = _pad(t[so], cb * TILE)
            for n0 in range(0, c, ns):
                nw = min(ns, c - n0)
                total = torch.zeros(TILE, nw)
                for split in range(nsplit):
                    part = torch.zeros(TILE, nw)
                    for it in range(split * items // nsplit, (split + 1) * items // nsplit):
                        s = it // nrb if st == 1 else so
                        b = _pad(v[s], (it % nrb) * TILE)
                        vd, g, vin = video_side(s, (it % nrb) * TILE)
                        td, g2, tin, tv = text_side(s, cb * TILE)
                        dzt = _dz(_z(a, b, c, kc, n0, terms),
                                  (vd[None], g[None], vin[None]),
                                  (td[:, None], g2[:, None], tin[:, None], tv[:, None]), inv)
                        part = part + _second(dzt, b[:, n0:n0 + nw], dtype, terms)
                    total = total + part
                n = min(TILE, cc - cb * TILE)
                dt[so, cb * TILE:cb * TILE + n, n0:n0 + nw] = total[:n]
    return dv.to(dtype), dt.to(dtype)


# ------------------------------------------------------------ references
def _jax(v, t, valid, gv, gt, dtype):
    (jv, jt), vjp = jax.vjp(lambda a, b: jgrid.grid_lse2(a, b, jnp.asarray(valid), INV),
                            jnp.asarray(v).astype(JDT[dtype]), jnp.asarray(t).astype(JDT[dtype]))
    jdv, jdt = vjp((jnp.asarray(gv), jnp.asarray(gt)))
    return [np.asarray(x.astype(jnp.float32)) for x in (jv, jt, jdv, jdt)]


def _plain(v, t, valid, gv, gt):
    a, b = v.clone().requires_grad_(), t.clone().requires_grad_()
    pv, pt = grid_lse2_plain(a, b, torch.from_numpy(valid), INV)
    torch.autograd.backward([pv, pt], [torch.from_numpy(gv), torch.from_numpy(gt)])
    return [x.detach().float().numpy() for x in (pv, pt, a.grad, b.grad)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _check(names, got, want, valid, tol, label):
    """t_den is judged on its valid columns and apart on the invalid ones
    (they sit at NEG_FILL + log R and would set the scale)."""
    for name, g, w in zip(names, got, want):
        g = np.asarray(g.float() if isinstance(g, torch.Tensor) else g)
        pairs = [(name, g, w)]
        if name == "t_den":
            pairs = [("t_den", g[:, valid], w[:, valid]),
                     ("t_den invalid", g[:, ~valid], w[:, ~valid])]
        for n, x, y in pairs:
            if y.size:
                assert _rel(x, y) <= tol, (label, n, _rel(x, y))


SHAPES = [(2, 100, 70, 128, 3), (1, 40, 130, 256, 0)]  # S, R, Cc, C, invalid columns


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st_is_s", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_order_of_work_matches_jax_and_plain(dtype, st_is_s, shape):
    """R and Cc are no multiples of the tiles: the last row block and column
    tile are ragged, and invalid columns sit in both tiles."""
    s, r, cc, c, n_invalid = shape
    st = s if st_is_s else 1
    v, t, valid, gv, gt = _inputs(s, st, r, cc, c, n_invalid, seed=r + cc + st)
    tv, tt = torch.from_numpy(v).to(dtype), torch.from_numpy(t).to(dtype)
    got = _emulate_forward(tv, tt, valid, INV)
    jv, jt, _, _ = _jax(v, t, valid, gv, gt, dtype)
    pv, pt, _, _ = _plain(tv, tt, valid, gv, gt)
    _check(("v_den", "t_den"), got, (jv, jt), valid, TOL[dtype], "jax")
    _check(("v_den", "t_den"), got, (pv, pt), valid, TOL[dtype], "plain")
    if n_invalid:
        np.testing.assert_allclose(got[1][:, ~valid].numpy(), NEG_FILL + np.log(r), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st_is_s", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_order_of_work_matches_jax_and_plain(dtype, st_is_s, shape):
    """dv and dt from the forward's own v_den / t_den, dt split over three
    (or fewer) parts of its work list and summed in order."""
    s, r, cc, c, n_invalid = shape
    st = s if st_is_s else 1
    v, t, valid, gv, gt = _inputs(s, st, r, cc, c, n_invalid, seed=2 * r + cc + st)
    tv, tt = torch.from_numpy(v).to(dtype), torch.from_numpy(t).to(dtype)
    vden, tden = _emulate_forward(tv, tt, valid, INV)
    items = (s if st == 1 else 1) * -(-r // TILE)
    got = _emulate_backward(tv, tt, valid, vden, tden, torch.from_numpy(gv),
                            torch.from_numpy(gt), INV, nsplit=min(3, items))
    _, _, jdv, jdt = _jax(v, t, valid, gv, gt, dtype)
    _, _, pdv, pdt = _plain(tv, tt, valid, gv, gt)
    _check(("dv", "dt"), got, (jdv, jdt), valid, TOL[dtype], "jax")
    _check(("dv", "dt"), got, (pdv, pdt), valid, TOL[dtype], "plain")


def test_backward_slabs_and_panels_above_512_columns():
    """C 640 runs in float32 in three output slabs of 256, 256 and 128; z of
    each sums the depth panels in the order that ends with the slab's own
    (slabs 0 and 1: panel 1, then 0; slab 2: panel 0, then 1)."""
    s, st, r, cc, c = 1, 1, 40, 30, 640
    v, t, valid, gv, gt = _inputs(s, st, r, cc, c, 2, seed=7)
    tv, tt = torch.from_numpy(v), torch.from_numpy(t)
    vden, tden = _emulate_forward(tv, tt, valid, INV)
    got = _emulate_backward(tv, tt, valid, vden, tden, torch.from_numpy(gv),
                            torch.from_numpy(gt), INV, nsplit=1)
    _, _, jdv, jdt = _jax(v, t, valid, gv, gt, torch.float32)
    _check(("dv", "dt"), got, (jdv, jdt), valid, TOL[torch.float32], "jax")
    assert tgrid.bwd_slab(c, torch.float32) == 256 and tgrid.bwd_slab(c, torch.bfloat16) == 512


def _float64(v, t, valid, gv, gt):
    a = torch.from_numpy(v).double().requires_grad_()
    b = torch.from_numpy(t).double().requires_grad_()
    z = torch.matmul(a, b.transpose(1, 2)) * INV
    z = torch.where(torch.from_numpy(valid)[None, None], z, torch.tensor(NEG_FILL).double())
    vd, td = torch.logsumexp(z, 2), torch.logsumexp(z, 1)
    torch.autograd.backward([vd, td], [torch.from_numpy(gv).double(),
                                       torch.from_numpy(gt).double()])
    return [x.detach().numpy() for x in (vd, td, a.grad, b.grad)]


@pytest.mark.parametrize("st", [1, 2])
def test_plain_tf32_is_ten_times_further_from_float64(st):
    """The float32 kernels' 3xTF32 against plain TF32 (a_hi b_hi alone), each
    against a float64 reference: v_den, t_den, dv and dt."""
    v, t, valid, gv, gt = _inputs(2, st, 100, 70, 128, 3, seed=11 + st)
    tv, tt = torch.from_numpy(v), torch.from_numpy(t)
    ref = _float64(v, t, valid, gv, gt)
    errs = {}
    for terms in (3, 1):
        vden, tden = _emulate_forward(tv, tt, valid, INV, terms=terms)
        dv, dt = _emulate_backward(tv, tt, valid, vden, tden, torch.from_numpy(gv),
                                   torch.from_numpy(gt), INV, nsplit=2, terms=terms)
        errs[terms] = [_rel(x, y) for x, y in zip((vden, tden[:, valid], dv, dt),
                                                 (ref[0], ref[1][:, valid], ref[2], ref[3]))]
    for e3, e1 in zip(errs[3], errs[1]):
        assert e3 <= 1e-5 and e1 >= 10 * e3, errs


# -------------------------------------------------- the wrappers' C calls
def _fake_library(monkeypatch, calls):
    """Stand in for the kernel library: record each C call and return 0."""
    class Lib:
        def __getattr__(self, fn):
            def entry(*args):
                calls.append((fn, args))
                return 0
            return entry

    monkeypatch.setattr(_kernels, "library", lambda name: Lib())
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(tgrid, "_nsplit", lambda *args: 2)
    for name in ("milnce_grid_fwd", "milnce_grid_bwd"):
        monkeypatch.setitem(_kernels.LAUNCHES, name, 0)


def _offset(t):
    """The same values in a view 4 (float32) or 2 (bfloat16) bytes past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _wrapper_args(dtype):
    v, t, valid, gv, gt = _inputs(2, 1, 40, 30, 128, 2, seed=5)
    return (torch.from_numpy(v).to(dtype), torch.from_numpy(t).to(dtype),
            torch.from_numpy(valid).to(torch.int32), torch.from_numpy(gv), torch.from_numpy(gt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["video3", "text3"])
def test_wrappers_refuse_an_unaligned_operand(monkeypatch, dtype, operand):
    """An offset view of video3 or text3 (both staged by 16-byte cp.async)
    raises ValueError in the forward and the backward before any launch;
    the values read one by one (cvalid, v_den, t_den, g_v, g_t) take any
    offset."""
    calls = []
    _fake_library(monkeypatch, calls)
    v, t, cv, gv, gt = _wrapper_args(dtype)
    vden, tden = torch.zeros(gv.shape), torch.zeros(gt.shape)
    bad = dict(video3=v, text3=t)
    bad[operand] = _offset(bad[operand])
    match = f"{operand} must start on a 16-byte boundary"
    with pytest.raises(ValueError, match=match):
        tgrid.grid_lse2_forward(bad["video3"], bad["text3"], cv, INV)
    with pytest.raises(ValueError, match=match):
        tgrid.grid_lse2_backward(bad["video3"], bad["text3"], cv, vden, tden, gv, gt, INV)
    assert calls == [] and _kernels.LAUNCHES["milnce_grid_fwd"] == 0
    tgrid.grid_lse2_forward(v, t, _offset(cv), INV)
    tgrid.grid_lse2_backward(v, t, _offset(cv), _offset(vden), _offset(tden), _offset(gv),
                             _offset(gt), INV)
    assert [fn for fn, _ in calls] == ["milnce_grid_forward", "milnce_grid_backward"]
    fwd_args, bwd_args = calls[0][1], calls[1][1]
    assert fwd_args[7:13] == (2, 1, 40, 30, 128, -(-40 // tgrid.FWD_ROWS))
    assert bwd_args[10:17] == (2, 1, 40, 30, 128, 2, 128)
    assert _kernels.LAUNCHES["milnce_grid_fwd"] == 1 and _kernels.LAUNCHES["milnce_grid_bwd"] == 1


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("s,st,r,cc,c", [(6, 6, 4096, 768, 512), (6, 1, 4096, 768, 512),
                                         (6, 6, 1024, 192, 512), (6, 1, 1024, 192, 512),
                                         (2, 1, 36, 15, 128), (1, 1, 512, 3072, 512),
                                         (2, 2, 100, 70, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dt_splits_cover_the_work_list_once(monkeypatch, dtype, s, st, r, cc, c):
    """The dt kernel's split k takes items [k * n // nsplit, (k + 1) * n //
    nsplit) of the (stage, 64-row block) list: every item exactly once, no
    split empty, and at least two CTAs an SM where the list allows."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    slab = tgrid.bwd_slab(c, dtype)
    nsplit = tgrid._nsplit(None, cc, st, s, r, c, slab)
    items = (s if st == 1 else 1) * -(-r // tgrid.DT_ROWS)
    bounds = [(k * items // nsplit, (k + 1) * items // nsplit) for k in range(nsplit)]
    covered = [i for lo, hi in bounds for i in range(lo, hi)]
    assert covered == list(range(items))
    assert all(hi > lo for lo, hi in bounds)
    ctas = -(-cc // tgrid.DT_COLS) * st * -(-c // slab)
    assert nsplit == items or ctas * nsplit >= 2 * _Props.multi_processor_count
