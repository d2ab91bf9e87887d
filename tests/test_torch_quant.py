"""The port's int8 serving mode against the JAX package's.

Inputs and weights come from numpy seeds and reach both sides as arrays (the
port through its weight bridge). The JAX int8 kernels run in interpret mode
on the CPU, as tests/test_attention.py and tests/test_ops.py run them; the
port's int8 kernel wrappers take their plain versions (mha_int8_plain,
mlp_int8_plain) on CPU tensors. Tolerances are stated per test. Where a JAX
function runs under jit, XLA turns ``absmax / 127`` into a multiplication by
the reciprocal (one ulp away for ~5% of scales), which can move a value on a
.5 rounding boundary to the next int8 step: those comparisons carry a
tolerance, the eager quantizers none.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.evals import AlignEvalConfig as JaxConfig
from exoground_tpu.evals import FusedAlignEvaluator as JaxEvaluator
from exoground_tpu.evals import align_fused as jfused
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.ops import attention as jattn
from exoground_tpu.ops import blocks as jblocks
from exoground_tpu.ops import fused_mlp as jmlp
from exoground_tpu.ops import quant as jquant
from exoground_tpu.serve import AlignmentService as JaxService
from exoground_tpu.serve import AlignRequest as JaxRequest
from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
from exoground_tpu_torch.evals import align as talign
from exoground_tpu_torch.evals import align_fused as tfused
from exoground_tpu_torch.evals.bench_items import make_item
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.ops import attention as tattn
from exoground_tpu_torch.ops import blocks as tblocks
from exoground_tpu_torch.ops import fused_mlp as tmlp
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.serve import AlignmentService, AlignRequest
from exoground_tpu_torch.utils.convert import load_tan_params


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


# ------------------------------------------------------------- quantizers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_last_axis_matches_jax(dtype):
    """Per-row int8 values and scales array-equal with the JAX quantizer,
    zero rows (scale 1) included; bfloat16 rows are widened first."""
    rng = np.random.RandomState(0)
    x = _n(rng, 3, 7, 96) * np.exp(rng.standard_normal((3, 7, 1))).astype(np.float32)
    x[1, 2] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = jquant._quant_last_axis(jx)
    tq, ts = quant._quant_last_axis(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 7, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 2, 0] == 1.0 and (tq[1, 2] == 0).all()


def test_quant_first_axis_matches_jax_transposed():
    """Per output channel: the torch-layout (N, K) weight reduces over dim 1,
    the JAX (K, N) kernel over axis 0."""
    rng = np.random.RandomState(1)
    w = _n(rng, 80, 48) * np.exp(rng.standard_normal((1, 48))).astype(np.float32)
    w[:, 5] = 0.0  # a dead output channel
    jq, js = jquant._quant_first_axis(jnp.asarray(w))
    tq, ts = quant._quant_first_axis(_t(w.T))
    assert tq.shape == (48, 80) and ts.shape == (48,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])


@pytest.mark.parametrize("shape", [(5, 64), (2, 9, 64)])
def test_int8_matmul_and_linear_match_jax(shape):
    """_int8_matmul and linear (bias added after the cast) against the JAX
    _int8_matmul / matmul + b, array-equal: the int32 product is exact and
    the rescale is the same three float32 roundings."""
    rng = np.random.RandomState(2)
    x = _n(rng, *shape) * np.exp(rng.standard_normal(shape[:-1] + (1,))).astype(np.float32)
    w = _n(rng, 64, 40)
    b = _n(rng, 40)
    want = np.asarray(jquant._int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(quant._int8_matmul(_t(x), _t(w.T)).numpy(), want)
    with jquant.matmul_impl("int8"):
        want_b = np.asarray(jquant.matmul(jnp.asarray(x), jnp.asarray(w)) + jnp.asarray(b))
    with quant.matmul_impl("int8"), torch.no_grad():
        got_b = quant.linear(_t(x), _t(w.T), _t(b)).numpy()
    np.testing.assert_array_equal(got_b, want_b)


def test_int_mm_pads_to_the_cuda_shape_rules():
    """_int_mm is exact for shapes torch._int_mm's CUDA path refuses (few
    rows, K and N not multiples of 8): it pads with zeros and cuts back."""
    rng = np.random.RandomState(3)
    a = rng.randint(-127, 128, (3, 13)).astype(np.int8)
    b = rng.randint(-127, 128, (5, 13)).astype(np.int8)
    got = quant._int_mm(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_default_linear_is_exactly_f_linear():
    rng = np.random.RandomState(4)
    x, w, b = _t(_n(rng, 6, 32)), _t(_n(rng, 16, 32)), _t(_n(rng, 16))
    f = torch.nn.functional.linear
    assert quant.current_impl() == "default"
    assert torch.equal(quant.linear(x, w, b), f(x, w, b))
    with quant.matmul_impl("int8", min_cols=17):  # N = 16 < min_cols: exact
        assert torch.equal(quant.linear(x, w, b), f(x, w, b))


# ------------------------------------------------------------------ context
def test_context_scoping_and_restore():
    """Mirror of tests/test_quant.py: bad names raise, the previous impl and
    min_cols come back on exit, on an exception too, and nesting restores
    the outer threshold."""
    assert quant.current_impl() == "default"
    with pytest.raises(ValueError):
        with quant.matmul_impl("fp8"):
            pass
    with pytest.raises(RuntimeError, match="boom"):
        with quant.matmul_impl("int8", min_cols=128):
            assert (quant.current_impl(), quant.current_min_cols()) == ("int8", 128)
            with quant.matmul_impl("int8"):
                assert quant.current_min_cols() == quant.INT8_MIN_COLS_DEFAULT
            assert quant.current_min_cols() == 128
            raise RuntimeError("boom")
    assert quant.current_impl() == "default"
    assert quant.current_min_cols() == quant.INT8_MIN_COLS_DEFAULT


def test_min_cols_selectivity():
    """Products with fewer output columns than min_cols stay exact, wider
    ones quantize (tests/test_quant.py::test_int8_min_cols_selectivity)."""
    rng = np.random.RandomState(5)
    x = _t(_n(rng, 8, 64))
    narrow, wide = _t(_n(rng, 96, 64)), _t(_n(rng, 128, 64))
    with quant.matmul_impl("int8", min_cols=128), torch.no_grad():
        got_n, got_w = quant.linear(x, narrow), quant.linear(x, wide)
    assert torch.equal(got_n, x @ narrow.T)
    err = (got_w - x @ wide.T).abs().max() / (x @ wide.T).abs().max()
    assert 0 < err < 0.02


def test_matmul_impl_is_thread_local():
    inside, release, seen = threading.Event(), threading.Event(), {}

    def other():
        inside.wait(timeout=10)
        seen["impl"] = quant.current_impl()
        with quant.matmul_impl("int8", min_cols=7):
            seen["nested"] = (quant.current_impl(), quant.current_min_cols())
        seen["after"] = quant.current_impl()
        release.set()

    th = threading.Thread(target=other)
    th.start()
    with quant.matmul_impl("int8", min_cols=3):
        inside.set()
        assert release.wait(timeout=10)
        assert (quant.current_impl(), quant.current_min_cols()) == ("int8", 3)
    th.join(timeout=10)
    assert seen == {"impl": "default", "nested": ("int8", 7), "after": "default"}


@pytest.mark.parametrize("impl,min_cols,ok", [
    ("default", 1024, False), ("int8", 1024, True), ("int8", 1536, True),
    ("int8", 512, False), ("int8", 1537, False), ("int8", 0, False),
])
def test_kernel_gate(impl, min_cols, ok):
    """3C >= min_cols > C at C = 512 (the qkv kernel's gate)."""
    with quant.matmul_impl(impl, min_cols=min_cols):
        assert quant.kernel_gate(3 * 512, 512) is ok


# ---------------------------------------------------------------- kernels
def _mha_weights(rng, c):
    return dict(in_proj_kernel=_n(rng, c, 3 * c, scale=c ** -0.5),
                in_proj_bias=_n(rng, 3 * c, scale=0.02),
                out_proj_kernel=_n(rng, c, c, scale=c ** -0.5),
                out_proj_bias=_n(rng, c, scale=0.02))


def _torch_mha(p):
    return (_t(p["in_proj_kernel"].T), _t(p["in_proj_bias"]),
            _t(p["out_proj_kernel"].T), _t(p["out_proj_bias"]))


def _mha_module(p, c, h):
    mod = tattn.MultiHeadAttention(c, h)
    mod.load_state_dict({"in_proj_weight": _t(p["in_proj_kernel"].T),
                         "in_proj_bias": _t(p["in_proj_bias"]),
                         "out_proj.weight": _t(p["out_proj_kernel"].T),
                         "out_proj.bias": _t(p["out_proj_bias"])})
    return mod


@pytest.mark.parametrize("s", [64, 96])
def test_fused_mha_int8_matches_jax_kernel(s):
    """fused_mha_int8 (mha_int8_plain on the CPU) against the JAX
    _fused_mha_int8 in interpret mode, float32, ragged windows with no fully
    masked one (the JAX kernel attends across the packed neighbour there).
    Tolerance 1e-4 of max|JAX|: the kernel's jitted scale may round one
    value to the neighbouring int8 step."""
    c, h, b = 128, 4, 3
    rng = np.random.RandomState(60 + s)
    x = _n(rng, b, s, c)
    p = _mha_weights(rng, c)
    kpad = np.zeros((b, s), bool)
    kpad[0, int(s * 0.8):] = True
    kpad[2, s // 3:] = True
    want = np.asarray(jattn._fused_mha_int8(
        jnp.asarray(x), jnp.asarray(kpad.astype(np.int32)),
        *(jnp.asarray(p[k]) for k in ("in_proj_kernel", "in_proj_bias", "out_proj_kernel",
                                      "out_proj_bias")), h))
    with torch.no_grad():
        got = tattn.fused_mha_int8(_t(x), _t(kpad), *_torch_mha(p), h).numpy()
    assert _rel(got, want) <= 1e-4
    exact = tattn.mha_plain(_t(x), _t(kpad), *_torch_mha(p), h).numpy()
    assert _rel(got, exact) > 1e-5  # the projection really was quantized


def test_fused_mha_int8_fully_masked_window_averages_its_own_values():
    """The port's rule for a padded group window: its keys all padding, it
    averages its own S int8-projected values, as attention_plain does."""
    c, h, s = 128, 4, 40
    rng = np.random.RandomState(7)
    x = _t(_n(rng, 2, s, c))
    w_in, b_in, w_out, b_out = _torch_mha(_mha_weights(rng, c))
    kpad = torch.zeros(2, s, dtype=torch.bool)
    kpad[0] = True
    with torch.no_grad():
        got = tattn.fused_mha_int8(x, kpad, w_in, b_in, w_out, b_out, h)
        acc, xs, ws = quant.int8_product(x[0], w_in)
        v = (acc.float() * xs * ws + b_in)[:, 2 * c:]
        want = torch.nn.functional.linear(v.mean(0), w_out, b_out)
        alone = tattn.fused_mha_int8(x[1:], kpad[1:], w_in, b_in, w_out, b_out, h)
    np.testing.assert_allclose(got[0].numpy(), want.expand(s, c).numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[1:].numpy(), alone.numpy(), atol=1e-6)


def _mlp_weights(rng, c):
    return (_n(rng, c, 4 * c, scale=c ** -0.5), _n(rng, 4 * c, scale=0.02),
            _n(rng, 4 * c, c, scale=(4 * c) ** -0.5), _n(rng, c, scale=0.02))


def test_fused_mlp_int8_matches_jax_kernel():
    """fused_mlp_int8 (mlp_int8_plain on the CPU) against the JAX
    fused_mlp_int8 in interpret mode, float32, with a zero row; 1e-4 of
    max|JAX| (the jitted scale, as above)."""
    rng = np.random.RandomState(40)
    c = 128
    x = _n(rng, 3, 70, c)
    x[1, 4] = 0.0
    fck, fcb, prk, prb = _mlp_weights(rng, c)
    want = jmlp.fused_mlp_int8(*(jnp.asarray(a) for a in (x, fck, fcb, prk, prb)))
    with torch.no_grad():
        got = tmlp.fused_mlp_int8(_t(x), _t(fck.T), _t(fcb), _t(prk.T), _t(prb)).numpy()
    assert _rel(got, want) <= 1e-4
    assert _rel(got, tmlp.mlp_plain(_t(x), _t(fck.T), _t(fcb), _t(prk.T), _t(prb))) > 1e-5


# --------------------------------------------------------- module dispatch
def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args):
        log.append(name)
        return real(*args)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("min_cols", [256, 1, 4096])
def test_mha_module_int8_dispatch(monkeypatch, min_cols):
    """Self-attention under matmul_impl('int8', min_cols): 256 (qkv N = 384
    quantized, out-proj N = 128 exact) takes fused_mha_int8 and matches the
    JAX module's int8 kernel; 1 keeps the unfused quant.linear path and
    matches the JAX unfused path; 4096 is bit-identical to the default
    context. Tolerances 1e-4 of max|JAX| (the jitted scale), 2e-5 unfused."""
    c, h = 128, 4
    rng = np.random.RandomState(70)
    p = _mha_weights(rng, c)
    x = _n(rng, 2, 64, c)
    kpad = np.zeros((2, 64), bool)
    kpad[1, 50:] = True
    mod = _mha_module(p, c, h)
    routed = []
    _spy(monkeypatch, tattn, "fused_mha_int8", routed)
    _spy(monkeypatch, tattn, "fused_mha", routed)
    tx = _t(x)
    with torch.no_grad():
        default = mod(tx, tx, tx, _t(kpad))
        with quant.matmul_impl("int8", min_cols=min_cols):
            got = mod(tx, tx, tx, _t(kpad)).numpy()
    jx = jnp.asarray(x)
    with jquant.matmul_impl("int8", min_cols=min_cols):
        want = np.asarray(jattn.MultiHeadAttention(num_heads=h).apply(
            {"params": p}, jx, jx, jx, jnp.asarray(kpad),
            impl="fused" if min_cols == 256 else None))
    if min_cols == 256:
        assert routed == ["fused_mha", "fused_mha_int8"]
        assert _rel(got, want) <= 1e-4
    elif min_cols == 1:
        assert routed == ["fused_mha"]
        assert _rel(got, want) <= 2e-5
    else:
        assert routed == ["fused_mha"]
        np.testing.assert_array_equal(got, default.numpy())


@pytest.mark.parametrize("min_cols", [256, 1, 4096])
def test_mlp_module_int8_dispatch(monkeypatch, min_cols):
    """The MLP's rule at C = 128: 256 (c_fc N = 512 quantized, c_proj N =
    128 exact) takes fused_mlp_int8 and matches the JAX int8 kernel; 1
    takes the plain composition with quant.linear and matches the JAX Dense
    path; 4096 is bit-identical to the default context."""
    c = 128
    rng = np.random.RandomState(71)
    fck, fcb, prk, prb = _mlp_weights(rng, c)
    x = _n(rng, 2, 9, c)
    mod = tblocks.MLP(c)
    mod.load_state_dict({"c_fc.weight": _t(fck.T), "c_fc.bias": _t(fcb),
                         "c_proj.weight": _t(prk.T), "c_proj.bias": _t(prb)})
    routed = []
    _spy(monkeypatch, tblocks, "fused_mlp_int8", routed)
    _spy(monkeypatch, tblocks, "fused_mlp", routed)
    with torch.no_grad():
        default = mod(_t(x))
        with quant.matmul_impl("int8", min_cols=min_cols):
            got = mod(_t(x)).numpy()
    params = {"params": {"c_fc": {"kernel": fck, "bias": fcb},
                         "c_proj": {"kernel": prk, "bias": prb}}}
    with jquant.matmul_impl("int8", min_cols=min_cols):
        want = np.asarray(jblocks.MLP(c).apply(
            params, jnp.asarray(x), impl="fused" if min_cols == 256 else "xla"))
    if min_cols == 256:
        assert routed == ["fused_mlp", "fused_mlp_int8"]
        assert _rel(got, want) <= 1e-4
    elif min_cols == 1:
        assert routed == ["fused_mlp"]
        assert _rel(got, want) <= 2e-5
    else:
        assert routed == ["fused_mlp"]
        np.testing.assert_array_equal(got, default.numpy())


def test_cross_attention_projections_quantize():
    """The q/kv alias split takes quant.linear too, as the JAX module's
    quant.matmul (attention.py:1119-1122)."""
    c, h = 64, 4
    rng = np.random.RandomState(72)
    p = _mha_weights(rng, c)
    q, kv = _n(rng, 2, 10, c), _n(rng, 2, 7, c)
    with jquant.matmul_impl("int8"):
        want = jattn.MultiHeadAttention(num_heads=h).apply(
            {"params": p}, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), impl="xla")
    mod = _mha_module(p, c, h)
    tkv = _t(kv)
    with torch.no_grad(), quant.matmul_impl("int8"):
        got = mod(_t(q), tkv, tkv)
    assert _rel(got.numpy(), want) <= 2e-5


# ------------------------------------------------------------------ model
SMALL = dict(num_encoder_layers=2, num_joint_layers=2, width=128, heads=4,
             input_dim=48, max_pos=256)


def _numpy_params(model, dim, seed):
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, dim)), jnp.zeros((1, 2, dim)),
        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool))
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 or "pos_embed" in name
                    else sd.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def small_pair():
    jm = JaxAligner(**SMALL, attn_impl="fused", mlp_impl="fused")
    params = _numpy_params(jm, 48, 0)
    tm = TemporalAligner(**SMALL, device="cpu").eval()
    load_tan_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("min_cols", [256, 0])
def test_text_visual_sim_int8_matches_jax(small_pair, min_cols):
    """E2D2 width 128 under matmul_impl('int8', min_cols): 256 runs both int8
    kernels in every layer (and the exact 48 -> 128 pre-projections), 0
    quantizes every projection on the unfused path. Tolerance 1e-3 of
    max|JAX| on the similarities: upstream float32 differences between the
    frameworks may move a value across a .5 rounding boundary."""
    jm, params, tm = small_pair
    rng = np.random.RandomState(8)
    video, lang = _n(rng, 2, 24, 48), _n(rng, 2, 5, 48)
    vmask = np.zeros((2, 24), bool)
    vmask[1, -7:] = True
    lmask = np.zeros((2, 5), bool)
    lmask[0, -2:] = True
    with jquant.matmul_impl("int8", min_cols=min_cols):
        want = jm.apply(params, jnp.asarray(video), jnp.asarray(lang),
                        video_padding_mask=jnp.asarray(vmask),
                        lang_padding_mask=jnp.asarray(lmask),
                        method=JaxAligner.text_visual_sim)
    with torch.no_grad():
        exact = tm.text_visual_sim(_t(video), _t(lang), video_padding_mask=_t(vmask),
                                   lang_padding_mask=_t(lmask))
        with quant.matmul_impl("int8", min_cols=min_cols):
            got = tm.text_visual_sim(_t(video), _t(lang), video_padding_mask=_t(vmask),
                                     lang_padding_mask=_t(lmask))
    for k in ("sim", "dual-sim"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-3, k
        assert _rel(got[k].numpy(), exact[k].numpy()) > 1e-6, k


# -------------------------------------------------------------- evaluator
DIM = 32
ARCH = dict(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4,
            input_dim=DIM, max_pos=128)
CFG = dict(seq_len=32, global_len_bucket=32, text_bucket=8, group_videos=3)


@pytest.fixture(scope="module")
def eval_pair():
    jm = JaxAligner(**ARCH, attn_impl="fused", mlp_impl="fused")
    params = _numpy_params(JaxAligner(**ARCH, attn_impl="xla"), DIM, 0)
    tm = TemporalAligner(**ARCH, device="cpu")
    load_tan_params(tm, params)
    items = [make_item(s, v, DIM, DIM) for s, v in enumerate([70, 90, 60, 100])]
    return jm, params, tm, items


@pytest.mark.parametrize("fields", [
    dict(matmul_dtype="int8", int8_min_cols=256),
    dict(matmul_dtype="int8"),
    dict(transfer_dtype="int8"),
    dict(transfer_dtype="int4"),
])
def test_evaluator_int8_matches_jax(eval_pair, fields):
    """The port's evaluator against the JAX one in the same int8/int4
    configuration: R@1 equal, AUC within 1e-3, predict() scores within 1e-3
    of max|score| (the JAX body runs jitted: see the module docstring)."""
    jm, params, tm, items = eval_pair
    want_ev = JaxEvaluator(jm, params, JaxConfig(**CFG, **fields))
    got_ev = FusedAlignEvaluator(tm, AlignEvalConfig(**CFG, **fields), device="cpu")
    want, got = want_ev(items), got_ev(items)
    assert got["Recall"] == want["Recall"]
    assert abs(got["AUC"] - want["AUC"]) <= 1e-3
    for g, w in zip(got_ev.predict(items), want_ev.predict(items)):
        assert _rel(g["score"], w["score"]) <= 1e-3


# the JAX characterisation tests' model shape (tests/test_evals.py: E2D2 width 32)
CHAR_ARCH = dict(num_encoder_layers=2, num_joint_layers=2, width=32, heads=4, max_pos=128)


def _char_items(dim, n):
    """tests/test_evals.py::_synthetic_video_item's items."""
    rng_items = []
    for s in range(n):
        rng = np.random.RandomState(s)
        vlen, num_text = 120 + 11 * s, 14
        aligned = (rng.rand(num_text) > 0.4).astype(np.int64)
        aligned[0], aligned[1] = 1, 0
        centers = np.sort(rng.rand(num_text)) * (vlen - 10) + 5
        rng_items.append({
            "video": rng.randn(vlen, dim).astype(np.float32),
            "start": np.maximum(centers - rng.randint(2, 8, num_text), 0.0),
            "end": np.minimum(centers + rng.randint(2, 8, num_text), vlen),
            "aligned": aligned,
            "text_embed": rng.randn(num_text, dim).astype(np.float32),
        })
    return rng_items


def _char_port_model(dim):
    params = _numpy_params(JaxAligner(**CHAR_ARCH, input_dim=dim, attn_impl="xla"), dim, 1)
    tm = TemporalAligner(**CHAR_ARCH, input_dim=dim, device="cpu")
    load_tan_params(tm, params)
    return tm


def test_int8_compute_matches_f32():
    """Mirror of tests/test_evals.py::test_fused_eval_int8_compute_matches_f32:
    matmul_dtype='int8' keeps R@1 and moves AUC by less than 0.02 (but
    moves it); a default evaluator built after an int8 one is unchanged;
    int8_min_cols above every width is bit-identical to 'default'."""
    tm = _char_port_model(24)
    items = _char_items(24, 4)
    base = AlignEvalConfig(group_videos=2)
    ref = FusedAlignEvaluator(tm, base, device="cpu")(items)
    q = FusedAlignEvaluator(tm, dataclasses.replace(base, matmul_dtype="int8"),
                            device="cpu")(items)
    assert q["Recall"] == ref["Recall"], (q, ref)
    assert abs(q["AUC"] - ref["AUC"]) < 0.02 and q["AUC"] != ref["AUC"], (q, ref)
    assert FusedAlignEvaluator(tm, base, device="cpu")(items) == ref
    none = FusedAlignEvaluator(tm, dataclasses.replace(base, matmul_dtype="int8",
                                                       int8_min_cols=4096), device="cpu")
    assert none(items) == ref


def test_int8_transfer_matches_f32():
    """Mirror of test_fused_eval_int8_transfer_matches_f32: same R@1, AUC
    within 0.02 of the float32 transfer."""
    tm = _char_port_model(24)
    items = _char_items(24, 4)
    base = AlignEvalConfig(group_videos=2)
    ref = FusedAlignEvaluator(tm, base, device="cpu")(items)
    q = FusedAlignEvaluator(tm, dataclasses.replace(base, transfer_dtype="int8"),
                            device="cpu")(items)
    assert q["Recall"] == ref["Recall"], (q, ref)
    assert abs(q["AUC"] - ref["AUC"]) < 0.02, (q, ref)


def test_int4_transfer_characterization():
    """Mirror of test_fused_eval_int4_transfer_characterization at 4096-d:
    the int4 mode runs end to end with sane metrics (AUC within 0.1 of the
    float32 transfer); through the model, int4-dequantized features move the
    similarities by under 25% of their absmax, int8 ones by under 5% and
    under a third of int4's."""
    dim = 4096
    tm = _char_port_model(dim)
    items = _char_items(dim, 2)
    base = AlignEvalConfig(group_videos=2)
    ref = FusedAlignEvaluator(tm, base, device="cpu")(items)
    q = FusedAlignEvaluator(tm, dataclasses.replace(base, transfer_dtype="int4"),
                            device="cpu")(items)
    assert np.isfinite(q["AUC"]) and abs(q["AUC"] - ref["AUC"]) < 0.1, (q, ref)
    video, text = items[0]["video"][:64], items[0]["text_embed"][:8]

    def int4(a):
        return tfused._dequant_int4(*map(_t, tfused._quantize_rows_int4(a))).numpy()

    def int8(a):
        q8, s8 = tfused._quantize_rows(a)
        return q8.astype(np.float32) * s8[:, None]

    sim_fn = talign.make_tan_sim_fn(tm)
    zv, zt = np.zeros((1, 64), bool), np.zeros((1, 8), bool)
    s_ref = sim_fn(video[None], zv, text[None], zt)["sim"]
    d4 = np.abs(sim_fn(int4(video)[None], zv, int4(text)[None], zt)["sim"] - s_ref).max()
    d8 = np.abs(sim_fn(int8(video)[None], zv, int8(text)[None], zt)["sim"] - s_ref).max()
    scale = np.abs(s_ref).max()
    assert d4 < 0.25 * scale and d8 < 0.05 * scale and d8 < d4 / 3.0, (d4, d8, scale)


def test_host_quantizers_match_jax():
    """_quantize_rows, _quantize_rows_int4 (numpy, host) and _dequant_int4
    (torch, device) array-equal with the JAX package's; a zero row gets
    scale 1 and int4 padding 0x88 decodes to zeros."""
    rng = np.random.RandomState(9)
    x = _n(rng, 6, 256) * np.exp(rng.standard_normal((6, 1))).astype(np.float32)
    x[2] = 0.0
    for t_fn, j_fn in ((tfused._quantize_rows, jfused._quantize_rows),
                       (tfused._quantize_rows_int4, jfused._quantize_rows_int4)):
        (tq, ts), (jq, js) = t_fn(x), j_fn(x)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
    packed, scales = tfused._quantize_rows_int4(x)
    packed[3] = 0x88
    got = tfused._dequant_int4(_t(packed), _t(scales)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfused._dequant_int4(jnp.asarray(packed), jnp.asarray(scales))))
    assert (got[2] == 0).all() and (got[3] == 0).all()
    assert tfused._int4_group(4096) == 128 and tfused._int4_group(96) == 32


def test_plan_ships_quantized_tables(eval_pair):
    """The planner's int8/int4 buffers: int8 tables with float32 row scales,
    nibble-packed int4 tables padded with 0x88 and float16 group scales."""
    _, _, _, items = eval_pair
    for dt, vdtype, sdtype in (("int8", np.int8, np.float32), ("int4", np.uint8, np.float16),
                               ("float16", np.float16, np.float32)):
        (_, _, args, _), = [e for e in tfused._plan(items[:2], AlignEvalConfig(
            **CFG, transfer_dtype=dt)) if e[0] == "group"]
        vb, vscale, tb, tscale = args[:4]
        assert vb.dtype == vdtype and tb.dtype == vdtype
        assert vscale.dtype == sdtype and tscale.dtype == sdtype
        assert len(args) == 8
        if dt == "int4":
            assert vb.shape[1] == DIM // 2 and (vb[-1] == 0x88).all()


# ---------------------------------------------------------------- service
def test_alignment_service_int8_matches_jax(eval_pair):
    """AlignmentService(matmul_dtype='int8') against the JAX service: the
    JAX service's policy (int8_min_cols 0: every projection quantized,
    unfused); best seconds equal, scores within 1e-3 of max|score|."""
    jm, params, tm, items = eval_pair
    it = items[1]
    want = JaxService(jm, params, seq_len=32, matmul_dtype="int8").align(
        JaxRequest(video=it["video"], text_embeds=it["text_embed"]))
    svc = AlignmentService(tm, seq_len=32, matmul_dtype="int8", device="cpu")
    assert svc.cfg.matmul_dtype == "int8" and svc.cfg.int8_min_cols == 0
    got = svc.align(AlignRequest(video=it["video"], text_embeds=it["text_embed"]))
    assert got["best_second"] == want["best_second"]
    assert _rel(got["score"], want["score"]) <= 1e-3


# ----------------------------------------------------------- guard rails
def test_int8_mode_is_not_differentiable():
    """Under an int8 context a product whose inputs require grad raises, in
    quant.linear, both kernel wrappers (on any device) and a module call."""
    rng = np.random.RandomState(10)
    x = _t(_n(rng, 2, 16, 128)).requires_grad_()
    w = _t(_n(rng, 384, 128))
    with quant.matmul_impl("int8"), pytest.raises(RuntimeError, match="not differentiable"):
        quant.linear(x, w)
    w_in, b_in, w_out, b_out = _torch_mha(_mha_weights(rng, 128))
    with pytest.raises(RuntimeError, match="inference-only"):
        tattn.fused_mha_int8(x, None, w_in, b_in, w_out, b_out, 4)
    fck, fcb, prk, prb = (_t(a) for a in _mlp_weights(rng, 128))
    with pytest.raises(RuntimeError, match="inference-only"):
        tmlp.fused_mlp_int8(x, fck.T.contiguous(), fcb, prk.T.contiguous(), prb)
    mlp = tblocks.MLP(128)  # parameters require grad
    with quant.matmul_impl("int8", min_cols=1), pytest.raises(RuntimeError,
                                                              match="not differentiable"):
        mlp(x.detach())
    with quant.matmul_impl("int8", min_cols=1), torch.no_grad():
        assert mlp(x).shape == x.shape


@pytest.mark.parametrize("field,value", [
    ("transfer_dtype", "bfloat16"), ("matmul_dtype", "fp8"),
])
def test_config_rejects_unknown_values(field, value):
    with pytest.raises(ValueError, match=field):
        AlignEvalConfig(**{field: value})


def test_config_accepts_the_int8_serving_point():
    cfg = AlignEvalConfig(compute_dtype="bfloat16", transfer_dtype="float16",
                          matmul_dtype="int8", int8_min_cols=1024)
    assert (cfg.matmul_dtype, cfg.int8_min_cols) == ("int8", 1024)
    for dt in ("int8", "int4"):
        assert AlignEvalConfig(transfer_dtype=dt).transfer_dtype == dt
