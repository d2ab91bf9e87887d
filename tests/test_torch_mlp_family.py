"""The MLP family's tensor-core tile (csrc/mlp_tile.cuh) checked on the CPU.

The CUDA kernels run only on the card (chip_smoke.py phases 3, 3d and 3e hold
them against their plain versions there). Here their order of work is
emulated on the same inputs and held against the plain versions and the JAX
Pallas kernels in interpret mode, as tests/test_torch_blocks.py runs them:
the whole-row LayerNorm statistics applied per K chunk, the int8
quantization with whole-row scales and its int32 sums per chunk, the
dequantization in the plain version's order, the float32 products in
3xTF32, and the hidden's partials summed in split order, then b_proj and
the residual, rounded once. Beside it: the cache of quantized weights the
int8 wrappers use, the launch plan and workspace the wrappers hand the
kernels, and their alignment checks.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.ops import fused_mlp as jmlp
from exoground_tpu_torch.ops import _kernels, quant
from exoground_tpu_torch.ops import fused_mlp as tmlp
from exoground_tpu_torch.ops.activations import quick_gelu

BODIES = ("mlp_int8", "block", "block_int8")
# max error / max|reference|: float32 summation order (the int8 block body:
# a last-bit LN difference can flip one int8 step of one of C terms), bfloat16
# roundings of intermediates; chip_smoke's limits
TOL = {("float32", False): 1e-4, ("float32", True): 1e-3, ("bfloat16", False): 1e-2,
       ("bfloat16", True): 1e-2}


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------- the quantized-weight cache
def test_quantized_weight_is_the_plain_quantizer_and_cached():
    w = torch.from_numpy(_n(np.random.RandomState(0), 64, 32))
    q, s = quant.quantized_weight(w)
    want_q, want_s = quant._quant_first_axis(w)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    again = quant.quantized_weight(w)
    assert again[0] is q and again[1] is s


def test_quantized_weight_is_recomputed_after_an_in_place_update():
    w = torch.from_numpy(_n(np.random.RandomState(1), 64, 32))
    q, _ = quant.quantized_weight(w)
    with torch.no_grad():
        w[3].mul_(-5.0)
    q2, s2 = quant.quantized_weight(w)
    want_q, want_s = quant._quant_first_axis(w)
    assert q2 is not q
    assert torch.equal(q2, want_q) and torch.equal(s2, want_s)
    assert not torch.equal(q2, q)


def test_equal_weights_get_separate_entries():
    a = torch.from_numpy(_n(np.random.RandomState(2), 16, 8))
    b = a.clone()
    qa, _ = quant.quantized_weight(a)
    qb, _ = quant.quantized_weight(b)
    assert qa is not qb and torch.equal(qa, qb)
    assert id(a) in quant._WEIGHT_CACHE and id(b) in quant._WEIGHT_CACHE


def test_entry_goes_when_the_weight_dies():
    w = torch.from_numpy(_n(np.random.RandomState(3), 16, 8))
    quant.quantized_weight(w)
    key = id(w)
    assert key in quant._WEIGHT_CACHE
    del w
    gc.collect()
    assert key not in quant._WEIGHT_CACHE


def test_inference_tensor_is_quantized_without_an_entry():
    with torch.inference_mode():
        w = torch.from_numpy(_n(np.random.RandomState(4), 16, 8)).clone()
    assert w.is_inference()
    q, s = quant.quantized_weight(w)
    want_q, want_s = quant._quant_first_axis(w)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert id(w) not in quant._WEIGHT_CACHE


# ----------------------------------------------- the kernels' order of work
KC_EXACT, KC_INT8, HC = 64, 128, 128  # K of a first-product step; hidden chunk


def _tf32(a):
    """float32 truncated to TF32: the kernels' bit mask for a_hi, and what
    the tensor core reads of an f32 operand."""
    bits = a.contiguous().view(torch.int32) & -8192  # 0xFFFFE000
    return bits.view(torch.float32)


def _product(a, b):
    """a . b^T as the tile computes it: bfloat16 operands exactly in float32
    with float32 sums; float32 operands in 3xTF32 (a_lo b_hi + a_hi b_lo +
    a_hi b_hi, each TF32 product exact in float32)."""
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float().T
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def _emulate(body, x, ln_w, ln_b, fc_w, fc_b, pr_w, pr_b, split):
    """One output of the tile, in its order of work (mlp_tile.cuh)."""
    rows, c = x.shape
    xf = x.float()
    ln = body != "mlp_int8"
    int8 = body != "block"
    if ln:  # whole-row statistics, two passes, IEEE root and quotient
        mean = xf.sum(-1, keepdim=True) / c
        rstd = 1.0 / torch.sqrt(((xf - mean) ** 2).sum(-1, keepdim=True) / c + tmlp.LN_EPS)

    def a_chunk(k0, k1):  # the first product's operand, columns [k0, k1)
        if not ln:
            return xf[:, k0:k1]
        return (xf[:, k0:k1] - mean) * rstd * ln_w[k0:k1].float() + ln_b[k0:k1].float()

    if int8:  # whole-row scales of x or of the float32 LN output
        kc = KC_INT8
        absmax = torch.stack([a_chunk(k, k + kc).abs().amax(-1) for k in range(0, c, kc)],
                             -1).amax(-1, keepdim=True)
        xs = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0),
                         torch.ones_like(absmax))
        fq, fs = quant._quant_first_axis(fc_w)
    chunks = 4 * c // HC
    partials = []
    for z in range(split):
        acc = torch.zeros(rows, c)
        for j in range(z * chunks // split, (z + 1) * chunks // split):
            cols = slice(j * HC, (j + 1) * HC)
            if int8:
                h32 = torch.zeros(rows, HC, dtype=torch.int64)
                for k in range(0, c, KC_INT8):
                    q = torch.clamp(torch.round(a_chunk(k, k + KC_INT8) / xs), -127, 127)
                    h32 += q.long() @ fq[cols, k:k + KC_INT8].long().T
                h = h32.float() * xs * fs[cols] + fc_b[cols].float()
            else:
                h = torch.zeros(rows, HC)
                for k in range(0, c, KC_EXACT):
                    a = a_chunk(k, k + KC_EXACT).to(x.dtype)  # xn rounded to x's type
                    h += _product(a, fc_w[cols, k:k + KC_EXACT])
                h = h + fc_b[cols].float()
            acc += _product(quick_gelu(h).to(pr_w.dtype), pr_w[:, cols])
        partials.append(acc)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    out = out + pr_b.float()
    if ln:
        out = out + xf
    return out.to(x.dtype)


def _inputs(c, seed):
    rng = np.random.RandomState(seed)
    x = _n(rng, 70, c)
    x[5] = 0.0  # a zero row: int8 scale 1, LN gives its bias
    x[9] = 0.25  # a constant row
    ln = (1.0 + 0.05 * _n(rng, c), 0.05 * _n(rng, c))
    w = (_n(rng, 4 * c, c, scale=c ** -0.5), _n(rng, 4 * c, scale=0.02),
         _n(rng, c, 4 * c, scale=(4 * c) ** -0.5), _n(rng, c, scale=0.02))
    return x, ln, w


_JAX = {}


def _jax_kernel(body, c, dtype, seed):
    """The JAX Pallas kernel (interpret mode) on the inputs, once per case."""
    key = (body, c, dtype, seed)
    if key not in _JAX:
        x, (g, b), (fk, fb, pk, pb) = _inputs(c, seed)
        j = [jnp.asarray(a).astype(dtype) for a in (x, g, b, fk.T, fb, pk.T, pb)]
        if body == "mlp_int8":
            _JAX[key] = _f32(jmlp.fused_mlp_int8(j[0], *j[3:]))
        else:
            _JAX[key] = _f32(jmlp.fused_block_mlp(*j, int8_cfc=body == "block_int8"))
    return _JAX[key]


@pytest.mark.parametrize("c", [128, 640])
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", BODIES)
def test_tile_order_of_work_matches_plain_and_jax(body, dtype, split, c):
    """The emulated tile against the plain version and the JAX kernel, for
    each body, type and split (C 640: five first-product steps of 128 int8
    or ten of 64, two 512-column slabs' worth of rows in one)."""
    seed = 100 + c
    x, (g, b), (fk, fb, pk, pb) = _inputs(c, seed)
    td = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(td) for a in (x, g, b, fk, fb, pk, pb)]
    got = _emulate(body, *t, split=split)
    assert got.dtype == td and got.shape == (70, c)
    if body == "mlp_int8":
        plain = tmlp.mlp_int8_plain(t[0], *t[3:])
    elif body == "block_int8":
        plain = tmlp.block_mlp_int8_plain(*t)
    else:
        plain = tmlp.block_mlp_plain(*t)
    tol = TOL[(dtype, body == "block_int8")]
    assert _rel(got, plain) <= tol
    assert _rel(got, _jax_kernel(body, c, dtype, seed)) <= tol


def test_split_partials_sum_in_order_to_the_unsplit_result():
    """In float32 the split changes only where the f32 partials are summed:
    the same terms, within float32 rounding of the unsplit sum."""
    x, (g, b), w = _inputs(128, 7)
    t = [torch.from_numpy(a) for a in (x, g, b, *w)]
    one = _emulate("block", *t, split=1)
    for split in (2, 4):
        assert _rel(_emulate("block", *t, split=split), one) <= 1e-6


def test_ln_per_chunk_with_whole_row_statistics_is_the_row_layernorm():
    """Normalizing each K chunk with the whole row's mean and rstd gives the
    row LayerNorm of the plain version (layernorm_f32)."""
    x, (g, b), _ = _inputs(640, 8)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, g, b))
    xf = tx.float()
    mean = xf.sum(-1, keepdim=True) / 640
    rstd = 1.0 / torch.sqrt(((xf - mean) ** 2).sum(-1, keepdim=True) / 640 + tmlp.LN_EPS)
    chunks = [(xf[:, k:k + 64] - mean) * rstd * tg[k:k + 64] + tb[k:k + 64]
              for k in range(0, 640, 64)]
    want = tmlp.layernorm_f32(tx, tg, tb)
    np.testing.assert_allclose(torch.cat(chunks, -1).numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------- the wrappers' launches
def _fake_library(monkeypatch, calls):
    """Stand in for the kernel libraries: record each C call and return 0."""
    class Lib:
        def __getattr__(self, fn):
            def entry(*args):
                calls.append((fn, args))
                return 0
            return entry

    monkeypatch.setattr(_kernels, "library", lambda name: Lib())
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    for name in ("fused_mlp", "fused_mlp_int8", "block_mlp", "block_mlp_int8"):
        monkeypatch.setitem(_kernels.LAUNCHES, name, 0)


def _wrapper_args(rows, c, dtype=torch.bfloat16):
    rng = np.random.RandomState(rows + c)
    x = torch.from_numpy(_n(rng, rows, c)).to(dtype)
    ln = (torch.ones(c, dtype=dtype), torch.zeros(c, dtype=dtype))
    w = (torch.from_numpy(_n(rng, 4 * c, c)).to(dtype), torch.zeros(4 * c, dtype=dtype),
         torch.from_numpy(_n(rng, c, 4 * c)).to(dtype), torch.zeros(c, dtype=dtype))
    return x, ln, w


LAUNCH_CASES = [("fused_mlp", "fused_mlp_forward", False, False),
                ("fused_mlp_int8", "fused_mlp_int8_forward", False, True),
                ("block_mlp", "block_mlp_forward", True, False),
                ("block_mlp_int8", "block_mlp_int8_forward", True, True)]


@pytest.mark.parametrize("rows,c", [(19456, 512), (29184, 512), (4096, 512), (1, 512),
                                    (300, 640), (40, 1280)])
@pytest.mark.parametrize("name,fn,block,int8", LAUNCH_CASES)
def test_wrappers_hand_the_kernel_its_plan_and_workspace(monkeypatch, name, fn, block, int8,
                                                         rows, c):
    """Each wrapper's C call: the operands in the entry point's order (x,
    the LayerNorm, c_fc or its int8 values and scales, the biases, c_proj,
    out), then the float32 workspace of split x rows x C (none without a
    split), rows, C, and mlp_launch_plan's slab and split."""
    calls = []
    _fake_library(monkeypatch, calls)
    x, ln, (fw, fb, pw, pb) = _wrapper_args(rows, c)
    seen = []
    real = tmlp.mlp_workspace

    def workspace(plan, r, cc, device):
        ws = real(plan, r, cc, device)
        seen.append(ws)
        return ws

    monkeypatch.setattr(tmlp, "mlp_workspace", workspace)
    with torch.no_grad():
        if block:
            out = tmlp._launch(name, "block_mlp", fn, x, fw, fb, pw, pb,
                               ln=dict(ln_w=ln[0], ln_b=ln[1]), int8=int8)
        else:
            out = tmlp._launch(name, name, fn, x, fw, fb, pw, pb, int8=int8)
    assert out.shape == x.shape and out.dtype == x.dtype
    plan = tmlp.mlp_launch_plan(rows, c)
    ((called, args),) = calls
    assert called == fn
    n_ptrs = 1 + 2 * block + (2 if int8 else 1) + 4
    assert len(args) == n_ptrs + 7
    assert args[n_ptrs + 1:n_ptrs + 5] == (rows, c, plan["slab"], plan["split"])
    assert args[n_ptrs + 5] == 1  # bfloat16
    (ws,) = seen
    if plan["split"] == 1:
        assert ws is None and args[n_ptrs] is None
    else:
        assert ws.shape == (plan["split"], rows, c) and ws.dtype == torch.float32
        assert args[n_ptrs] == ws.data_ptr()
    if int8:
        q, s = quant.quantized_weight(fw)
        assert args[1 + 2 * block:3 + 2 * block] == (q.data_ptr(), s.data_ptr())
    assert _kernels.LAUNCHES[name] == 1


@pytest.mark.parametrize("rows,c,split", [(19456, 512, 2), (29184, 512, 2), (4096, 512, 4),
                                          (1, 512, 16), (300, 640, 20), (40, 4224, 22)])
def test_launch_plan_and_workspace_shapes(rows, c, split):
    """The plans the wrappers use at the main path's rows, the split cases
    of chip_smoke and the other widths; the workspace a split needs."""
    plan = tmlp.mlp_launch_plan(rows, c)
    assert plan["split"] == split and plan["slab"] == min(c, 512)
    ws = tmlp.mlp_workspace(plan, rows, c, "meta")
    if split == 1:
        assert ws is None
    else:
        assert ws.shape == (split, rows, c) and ws.dtype == torch.float32


@pytest.mark.parametrize("name,fn,block,int8", LAUNCH_CASES)
def test_wrappers_refuse_an_unaligned_operand(monkeypatch, name, fn, block, int8):
    """An offset view of c_proj (every body) or of x (all but the int8 MLP:
    the exact bodies copy x by 16-byte cp.async, the block bodies' reduction
    reads it as vectors) raises ValueError before any launch."""
    calls = []
    _fake_library(monkeypatch, calls)
    x, ln, (fw, fb, pw, pb) = _wrapper_args(64, 128)
    kw = dict(ln=dict(ln_w=ln[0], ln_b=ln[1])) if block else {}
    lib = "block_mlp" if block else name

    def offset(t):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    with torch.no_grad():
        with pytest.raises(ValueError, match="pr_w must start on a 16-byte boundary"):
            tmlp._launch(name, lib, fn, x, fw, fb, offset(pw), pb, int8=int8, **kw)
        if int8 and not block:  # x is quantized in the kernel: any alignment serves
            tmlp._launch(name, lib, fn, offset(x), fw, fb, pw, pb, int8=int8, **kw)
            assert len(calls) == 1
        else:
            with pytest.raises(ValueError, match="x must start on a 16-byte boundary"):
                tmlp._launch(name, lib, fn, offset(x), fw, fb, pw, pb, int8=int8, **kw)
            assert calls == []
