"""The port's whole-block path against the JAX package's.

A block takes it under attn_impl="fused", mlp_impl="fused": two launches a
layer, ``fused_block_attn`` -> (x + MHA(LN_1(x)), LN_1(x)) and
``fused_block_mlp`` -> x + MLP(LN_2(x)), exact or with the int8 qkv and c_fc
products. Inputs and weights come from numpy seeds and reach both sides as
arrays (the port's weights through its bridge). The JAX block kernels run in
interpret mode on the CPU, as tests/test_ops.py::TestFusedWholeBlock runs
them; on the CPU the port's wrappers take their plain versions
(``block_attn_plain``, ``block_mlp_plain`` and the int8 twins), which the
CUDA kernels are held against on the card (chip_smoke.py phase 3e). Windows
keep at least one valid key: for a fully-masked window the JAX kernel
attends across its packed neighbour (ROADMAP.md §3). Tolerances are stated
per test; dispatch tests use meta tensors to stand for the card's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.evals import AlignEvalConfig as JaxConfig
from exoground_tpu.evals import FusedAlignEvaluator as JaxEvaluator
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.ops import attention as jattn
from exoground_tpu.ops import blocks as jblocks
from exoground_tpu.ops import fused_mlp as jmlp
from exoground_tpu.ops import quant as jquant
from exoground_tpu.serve import AlignmentService as JaxService
from exoground_tpu.serve import AlignRequest as JaxRequest
from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
from exoground_tpu_torch.evals.bench_items import make_item
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.ops import attention as tattn
from exoground_tpu_torch.ops import blocks as tblocks
from exoground_tpu_torch.ops import fused_mlp as tmlp
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.ops.activations import quick_gelu
from exoground_tpu_torch.serve import AlignmentService, AlignRequest
from exoground_tpu_torch.utils.convert import encoder_state_dict_from_jax, load_tan_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

C, H = 128, 4
ATOL, RTOL = 5e-5, 1e-4  # float32, as tests/test_ops.py:402-405


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a).astype(jnp.float32)))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want, dtype, tol=1e-2):
    """float32: atol 5e-5, rtol 1e-4; bfloat16: <= tol of max|want|."""
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL, rtol=RTOL)
    else:
        assert _rel(got, want) <= tol


def _ln(rng, c=C):
    return 1.0 + 0.05 * _n(rng, c), 0.05 * _n(rng, c)


def _attn_weights(rng, c=C):
    """JAX layout: in_proj_kernel (C, 3C), out_proj_kernel (C, C)."""
    return (_n(rng, c, 3 * c, scale=c ** -0.5), _n(rng, 3 * c, scale=0.02),
            _n(rng, c, c, scale=c ** -0.5), _n(rng, c, scale=0.02))


def _mlp_weights(rng, c=C):
    return (_n(rng, c, 4 * c, scale=c ** -0.5), _n(rng, 4 * c, scale=0.02),
            _n(rng, 4 * c, c, scale=(4 * c) ** -0.5), _n(rng, c, scale=0.02))


def _kpad(b, s):
    """Ragged key padding with a valid key in every window."""
    kpad = np.zeros((b, s), bool)
    kpad[0, int(s * 0.8):] = True
    kpad[2, s // 3:] = True
    return kpad


def _attn_case(s, seed):
    rng = np.random.RandomState(seed)
    x = _n(rng, 3, s, C)
    return x, _kpad(3, s), _ln(rng), _attn_weights(rng)


def _attn_both(x, kpad, ln, weights, dtype, int8):
    g, b = ln
    wi, bi, wo, bo = weights
    want = jattn.fused_block_attn(_j(x, dtype), jnp.asarray(kpad), _j(g, dtype), _j(b, dtype),
                                  _j(wi, dtype), _j(bi, dtype), _j(wo, dtype), _j(bo, dtype),
                                  H, int8_qkv=int8)
    with torch.no_grad():
        got = tattn.fused_block_attn(_t(x, dtype), _t(kpad), _t(g, dtype), _t(b, dtype),
                                     _t(wi.T, dtype), _t(bi, dtype), _t(wo.T, dtype),
                                     _t(bo, dtype), H, int8_qkv=int8)
    return got, want


def _mlp_case(seed):
    rng = np.random.RandomState(seed)
    x = _n(rng, 3, 70, C)
    x[1, 4] = 0.0  # a constant row: LN gives its bias, the int8 scale its absmax
    return x, _ln(rng), _mlp_weights(rng)


def _mlp_args(x, ln, weights, dtype, framework):
    g, b = ln
    fk, fb, pk, pb = weights
    if framework == "jax":
        return tuple(_j(a, dtype) for a in (x, g, b, fk, fb, pk, pb))
    return tuple(_t(a, dtype) for a in (x, g, b, fk.T, fb, pk.T, pb))


# ------------------------------------------------- kernels' plain versions
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 96])
def test_block_attn_matches_jax_kernel(s, dtype):
    """block_attn_plain (fused_block_attn on the CPU) against the JAX
    _block_attn kernel: the block output and x_norm."""
    x, kpad, ln, weights = _attn_case(s, 80 + s)
    (got_x, got_n), (want_x, want_n) = _attn_both(x, kpad, ln, weights, dtype, int8=False)
    assert got_x.dtype == got_n.dtype == getattr(torch, dtype)
    _close(got_x, want_x, dtype)
    _close(got_n, want_n, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 96])
def test_block_attn_int8_matches_jax_kernel(s, dtype):
    """block_attn_int8_plain against the JAX _block_attn_kernel_int8; the
    output within 1e-3 (float32) or 1e-2 (bfloat16) of max|JAX|: a
    float32 LN difference in the last bit can move one value across a .5
    rounding boundary, one int8 step of one of C terms; x_norm as the
    exact body's."""
    x, kpad, ln, weights = _attn_case(s, 90 + s)
    (got_x, got_n), (want_x, want_n) = _attn_both(x, kpad, ln, weights, dtype, int8=True)
    assert _rel(got_x, want_x) <= (1e-3 if dtype == "float32" else 1e-2)
    _close(got_n, want_n, dtype)
    (exact, _), _ = _attn_both(x, kpad, ln, weights, dtype, int8=False)
    assert _rel(got_x, exact) > 1e-5  # the qkv product really was quantized


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_mlp_matches_jax_kernel(dtype):
    """block_mlp_plain against the JAX _block_mlp_kernel. The plain version
    follows the kernel, which sums the residual in float32 and rounds once;
    _block_mlp_xla (the JAX custom VJP's forward rule) rounds the MLP output
    to bfloat16 first, so in bfloat16 it sits further off (<= 1e-2)."""
    x, ln, weights = _mlp_case(40)
    want = jmlp.fused_block_mlp(*_mlp_args(x, ln, weights, dtype, "jax"))
    with torch.no_grad():
        got = tmlp.fused_block_mlp(*_mlp_args(x, ln, weights, dtype, "torch"))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, dtype, tol=2e-3)
    xla = jmlp._block_mlp_xla(*(a.reshape(-1, C) if i == 0 else a for i, a in
                                enumerate(_mlp_args(x, ln, weights, dtype, "jax"))))
    _close(got.reshape(-1, C), xla, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_mlp_int8_matches_jax_kernel(dtype):
    """block_mlp_int8_plain against the JAX _block_mlp_kernel_int8: 1e-4 of
    max|JAX| in float32 (a one-step flip allowed), 1e-2 in bfloat16."""
    x, ln, weights = _mlp_case(41)
    want = jmlp.fused_block_mlp(*_mlp_args(x, ln, weights, dtype, "jax"), int8_cfc=True)
    args = _mlp_args(x, ln, weights, dtype, "torch")
    with torch.no_grad():
        got = tmlp.fused_block_mlp(*args, int8_cfc=True)
        exact = tmlp.fused_block_mlp(*args)
    assert _rel(got, want) <= (1e-4 if dtype == "float32" else 1e-2)
    assert _rel(got, exact) > 1e-5


def test_int8_bodies_quantize_the_float32_x_norm():
    """In bfloat16 the int8 body quantizes the unrounded float32 LN output
    (fused_mlp.py:162-163), not the bfloat16 x_norm the per-module int8
    path quantizes: on these inputs the two give other int8 values, and the
    port's output agrees with the JAX kernel to the bit almost everywhere
    while the bfloat16-xn composition does not."""
    x, ln, weights = _mlp_case(42)
    args = _mlp_args(x, ln, weights, "bfloat16", "torch")
    tx, g, b, fc_w, fc_b, pr_w, pr_b = args
    want = _f32(jmlp.fused_block_mlp(*_mlp_args(x, ln, weights, "bfloat16", "jax"),
                                     int8_cfc=True))
    with torch.no_grad():
        got = _f32(tmlp.fused_block_mlp(*args, int8_cfc=True))
        xn32 = tmlp.layernorm_f32(tx, g, b)
        q32, _ = quant._quant_last_axis(xn32)
        q16, _ = quant._quant_last_axis(xn32.to(torch.bfloat16))
        acc, xs, ws = quant.int8_product(xn32.to(torch.bfloat16), fc_w)
        h = quick_gelu(acc.float() * xs * ws + fc_b.float())
        alt = _f32(tmlp._c_proj_residual(h, tx, pr_w, pr_b))
    assert (q32 != q16).any()
    assert (got == want).mean() > 0.99 and (alt == want).mean() < 0.9
    assert np.abs(got - want).mean() < 0.1 * np.abs(alt - want).mean()


def _count_blocks(monkeypatch):
    """Record every launch of the two block wrappers the blocks make."""
    log = []
    for name in ("fused_block_attn", "fused_block_mlp"):
        real = getattr(tblocks, name)

        def spy(*a, _n=name, _f=real, **kw):
            log.append((_n, bool(kw.get("int8_qkv", kw.get("int8_cfc")))))
            return _f(*a, **kw)

        monkeypatch.setattr(tblocks, name, spy)
    return log


# ------------------------------------------------------------- autograd
def test_block_path_autograd_matches_jax_grad(monkeypatch):
    """On the CPU the block path is differentiable through its plain
    versions; its gradients (every parameter and x) against jax.grad of the
    JAX block path, whose custom VJP differentiates the XLA composition
    (tolerances of tests/test_ops.py:430)."""
    rng = np.random.RandomState(70)
    x, kpad = _n(rng, 3, 64, C), _kpad(3, 64)
    blk = jblocks.ResidualAttentionBlock(width=C, heads=H)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + _n(rng, *a.shape, scale=0.05),
        blk.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(kpad))["params"])

    def loss(p, xx):
        xo, xn = blk.apply({"params": p}, xx, jnp.asarray(kpad), impl="fused",
                           mlp_impl="fused")
        return jnp.sum(xo ** 2) + jnp.sum(xn ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    enc = tblocks.TemporalEncoder(C, 1, H)
    enc.load_state_dict(encoder_state_dict_from_jax({"resblocks_0": params}), strict=True)
    tx = _t(x).requires_grad_()
    log = _count_blocks(monkeypatch)
    xo, xn = enc.resblocks[0](tx, _t(kpad), impl="fused", mlp_impl="fused")
    assert log == [("fused_block_attn", False), ("fused_block_mlp", False)]
    ((xo ** 2).sum() + (xn ** 2).sum()).backward()
    want = encoder_state_dict_from_jax({"resblocks_0": gp})
    got = dict(enc.named_parameters())
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), w.numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------------- model
SMALL = dict(num_encoder_layers=2, num_joint_layers=2, width=C, heads=H, input_dim=48,
             max_pos=256, use_alignability_head=1)


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
    tm = TemporalAligner(**SMALL, attn_impl="fused", mlp_impl="fused", device="cpu").eval()
    load_tan_params(tm, params)
    return jm, params, tm


def _model_inputs(seed):
    rng = np.random.RandomState(seed)
    video, lang = _n(rng, 2, 24, 48), _n(rng, 2, 5, 48)
    vmask = np.zeros((2, 24), bool)
    vmask[-1, -7:] = True
    lmask = np.zeros((2, 5), bool)
    lmask[0, -2:] = True
    return video, lang, vmask, lmask


def test_aligner_block_path_matches_jax(small_pair, monkeypatch):
    """TemporalAligner(attn_impl="fused", mlp_impl="fused") E2D2 width 128
    against the JAX model of the same impls on the same weights: the
    training-shaped forward (two block launches in each of 2 + 2 layers)
    and text_visual_sim."""
    jm, params, tm = small_pair
    arrays = _model_inputs(1)
    log = _count_blocks(monkeypatch)
    want = jm.apply(params, *(jnp.asarray(a) for a in arrays), deterministic=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in arrays))
    assert log == [("fused_block_attn", False), ("fused_block_mlp", False)] * 4
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    video, lang, vmask, lmask = arrays
    want = jm.apply(params, jnp.asarray(video), jnp.asarray(lang),
                    video_padding_mask=jnp.asarray(vmask), lang_padding_mask=jnp.asarray(lmask),
                    method=JaxAligner.text_visual_sim)
    with torch.no_grad():
        got = tm.text_visual_sim(_t(video), _t(lang), video_padding_mask=_t(vmask),
                                 lang_padding_mask=_t(lmask))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_aligner_block_path_int8_matches_jax(small_pair, monkeypatch):
    """Under matmul_impl('int8', min_cols=256) (qkv N = 384 and c_fc N = 512
    quantized, the N = 128 products exact) every layer takes the int8 block
    bodies on both sides; similarities within 3e-3 of max|JAX|: a last-bit
    LN difference flips about one int8 value in the ~5e4 this call
    quantizes, and the step is carried through the later layers and the
    L2 normalisation (1.1e-3 on these inputs)."""
    jm, params, tm = small_pair
    video, lang, vmask, lmask = _model_inputs(2)
    log = _count_blocks(monkeypatch)
    with jquant.matmul_impl("int8", min_cols=256):
        want = jm.apply(params, jnp.asarray(video), jnp.asarray(lang),
                        video_padding_mask=jnp.asarray(vmask),
                        lang_padding_mask=jnp.asarray(lmask), method=JaxAligner.text_visual_sim)
    with torch.no_grad(), quant.matmul_impl("int8", min_cols=256):
        got = tm.text_visual_sim(_t(video), _t(lang), video_padding_mask=_t(vmask),
                                 lang_padding_mask=_t(lmask))
    assert log == [("fused_block_attn", True), ("fused_block_mlp", True)] * 4
    for k in ("sim", "dual-sim"):
        assert _rel(got[k], want[k]) <= 3e-3, k


def test_aligner_validates_mlp_impl():
    with pytest.raises(ValueError, match="mlp_impl"):
        TemporalAligner(num_encoder_layers=1, num_joint_layers=1, width=C, heads=H,
                        input_dim=16, max_pos=64, mlp_impl="triton", device="cpu")
    tm = TemporalAligner(num_encoder_layers=1, num_joint_layers=1, width=C, heads=H,
                         input_dim=16, max_pos=64, mlp_impl="xla", device="cpu")
    assert tm.mlp_impl == "xla" and tm.attn_impl is None


# ---------------------------------------------------- evaluator, service
DIM = 32
ARCH = dict(num_encoder_layers=1, num_joint_layers=1, width=C, heads=H, input_dim=DIM,
            max_pos=128)
CFG = dict(seq_len=32, global_len_bucket=32, text_bucket=8, group_videos=3)


@pytest.fixture(scope="module")
def eval_pair():
    jm = JaxAligner(**ARCH, attn_impl="fused", mlp_impl="fused")
    params = _numpy_params(JaxAligner(**ARCH, attn_impl="xla"), DIM, 0)
    tm = TemporalAligner(**ARCH, attn_impl="fused", mlp_impl="fused", device="cpu")
    load_tan_params(tm, params)
    items = [make_item(s, v, DIM, DIM) for s, v in enumerate([70, 90, 60, 100])]
    return jm, params, tm, items


@pytest.mark.parametrize("fields", [{}, dict(matmul_dtype="int8", int8_min_cols=256)])
def test_evaluator_block_path_matches_jax(eval_pair, monkeypatch, fields):
    """FusedAlignEvaluator over the fused model against the JAX evaluator,
    exact (R@1 within 1e-9, AUC within 1e-6, scores within 1e-5) and with
    the int8 block bodies (R@1 equal, AUC and scores within 1e-3: the JAX
    body runs jitted, tests/test_torch_quant.py)."""
    jm, params, tm, items = eval_pair
    log = _count_blocks(monkeypatch)
    want_ev = JaxEvaluator(jm, params, JaxConfig(**CFG, **fields))
    got_ev = FusedAlignEvaluator(tm, AlignEvalConfig(**CFG, **fields), device="cpu")
    want, got = want_ev(items), got_ev(items)
    int8 = bool(fields)
    assert log and set(log) == {("fused_block_attn", int8), ("fused_block_mlp", int8)}
    if int8:
        assert got["Recall"] == want["Recall"] and abs(got["AUC"] - want["AUC"]) <= 1e-3
    else:
        np.testing.assert_allclose(got["Recall"], want["Recall"], atol=1e-9)
        np.testing.assert_allclose(got["AUC"], want["AUC"], atol=1e-6)
    for g, w in zip(got_ev.predict(items), want_ev.predict(items)):
        if int8:
            assert _rel(g["score"], w["score"]) <= 1e-3
        else:
            np.testing.assert_array_equal(g["argmax"], w["argmax"])
            np.testing.assert_allclose(g["score"], w["score"], atol=1e-5, rtol=1e-5)


def test_alignment_service_block_path_matches_jax(eval_pair, monkeypatch):
    """AlignmentService over the fused model against the JAX service: best
    seconds equal, scores within 1e-5."""
    jm, params, tm, items = eval_pair
    it = items[1]
    log = _count_blocks(monkeypatch)
    want = JaxService(jm, params, seq_len=32).align(
        JaxRequest(video=it["video"], text_embeds=it["text_embed"]))
    got = AlignmentService(tm, seq_len=32, device="cpu").align(
        AlignRequest(video=it["video"], text_embeds=it["text_embed"]))
    assert log
    assert got["best_second"] == want["best_second"]
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-5, rtol=1e-5)


def test_evaluator_cast_reaches_the_layernorm_parameters(eval_pair):
    """The evaluator casts its copy once to compute_dtype, LayerNorm
    parameters included, so the block kernels get them in x's type."""
    _, _, tm, items = eval_pair
    ev = FusedAlignEvaluator(tm, AlignEvalConfig(**CFG, compute_dtype="bfloat16"), device="cpu")
    blk = ev._model.joint_temporal_encoder.resblocks[0]
    assert blk.ln_1.weight.dtype == blk.ln_2.bias.dtype == torch.bfloat16
    m = ev(items)
    assert 0.0 <= m["Recall"] <= 1.0 and 0.0 <= m["AUC"] <= 1.0


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("impl,width,device,disabled,want", [
    (None, 512, "cuda", False, "fused"), ("auto", 512, "cuda", False, "fused"),
    (None, 512, "meta", False, "fused"), (None, 512, "cpu", False, "xla"),
    (None, 512, "cuda", True, "xla"), ("fused", 512, "cuda", True, "fused"),
    ("fused", 512, "cpu", False, "fused"), ("fused", 96, "cuda", False, "xla"),
    ("xla", 512, "cuda", False, "xla"), ("auto", 640, "cuda", False, "fused"),
])
def test_resolve_mlp_impl(impl, width, device, disabled, want):
    """The counterpart of resolve_mlp_impl (fused_mlp.py:71-90) without the
    TPU's row gate: 'auto' takes the kernel off the CPU outside
    disable_fused_kernels(); an explicit 'fused' overrides the switch."""
    if disabled:
        with tmlp.disable_fused_kernels():
            assert tmlp.resolve_mlp_impl(impl, width, device) == want
    else:
        assert tmlp.resolve_mlp_impl(impl, width, device) == want
    with pytest.raises(ValueError, match="mlp impl"):
        tmlp.resolve_mlp_impl("small", width, device)


@pytest.mark.parametrize("impl,s,c,h,policy,want", [
    ("fused", 64, 512, 8, None, "exact"), ("fused", 96, 512, 8, None, "exact"),
    ("fused", 128, 128, 16, None, "exact"), (None, 64, 512, 8, None, None),
    ("auto", 64, 512, 8, None, None), ("xla", 64, 512, 8, None, None),
    ("flash", 64, 512, 8, None, None), ("fused", 129, 512, 8, None, None),
    ("fused", 64, 96, 3, None, None), ("fused", 64, 512, 8, 1024, "int8"),
    ("fused", 64, 512, 8, 1536, "int8"), ("fused", 64, 512, 8, 512, None),
    ("fused", 64, 512, 8, 1537, None), ("fused", 64, 512, 8, 0, None),
])
def test_block_fusion_mode(impl, s, c, h, policy, want):
    """The counterpart of block_fusion_mode (attention.py:860-887): an
    explicit 'fused' on a window the fused-MHA test admits; under int8 only
    the selective policy 3C >= min_cols > C."""
    if policy is None:
        assert tattn.block_fusion_mode(impl, s, c, h) == want
    else:
        with quant.matmul_impl("int8", min_cols=policy):
            assert tattn.block_fusion_mode(impl, s, c, h) == want


def _meta_block(monkeypatch, c=512, h=8):
    """A block on the meta device (standing for the card's) whose kernel
    wrappers only record their calls."""
    log = []

    def block_attn(x, *a, int8_qkv=False):
        log.append("block_attn_int8" if int8_qkv else "block_attn")
        return x, x

    def block_mlp(x, *a, int8_cfc=False):
        log.append("block_mlp_int8" if int8_cfc else "block_mlp")
        return x

    def recorder(name):
        def rec(x, *a):
            log.append(name)
            return x
        return rec

    monkeypatch.setattr(tblocks, "fused_block_attn", block_attn)
    monkeypatch.setattr(tblocks, "fused_block_mlp", block_mlp)
    monkeypatch.setattr(tattn, "fused_mha", recorder("fused_mha"))
    monkeypatch.setattr(tblocks, "fused_mlp", recorder("fused_mlp"))
    return tblocks.ResidualAttentionBlock(c, h).to("meta"), log


@pytest.mark.parametrize("disabled", [False, True])
def test_explicit_fused_takes_the_block_path_on_the_card(monkeypatch, disabled):
    """attn 'fused' + mlp 'fused' on a card tensor: two block launches, also
    inside disable_fused_kernels() (an explicit 'fused' overrides it, as
    in the JAX package); with mlp_impl None the MLP resolves 'auto', which
    the switch turns off, and the block falls to the per-module path, where
    the explicit 'fused' still takes fused_mha."""
    blk, log = _meta_block(monkeypatch)
    x = torch.empty(2, 64, 512, device="meta")
    ctx = tmlp.disable_fused_kernels() if disabled else torch.no_grad()
    with ctx, torch.no_grad():
        blk(x, impl="fused", mlp_impl="fused")
        blk(x, impl="fused")
    second = ["fused_mha"] if disabled else ["block_attn", "block_mlp"]
    assert log == ["block_attn", "block_mlp"] + second


def test_mlp_impl_xla_keeps_the_per_module_path(monkeypatch):
    blk, log = _meta_block(monkeypatch)
    x = torch.empty(2, 64, 512, device="meta")
    with torch.no_grad():
        xo, xn = blk(x, impl="fused", mlp_impl="xla")
    assert log == ["fused_mha"] and xo.shape == xn.shape == x.shape


def test_long_window_falls_to_the_per_module_path(monkeypatch):
    """S > 128: no block kernel; the attention takes the unfused
    projections with the 'auto' core, the MLP its kernel."""
    blk, log = _meta_block(monkeypatch)
    x = torch.empty(1, 130, 512, device="meta")
    with torch.no_grad():
        blk(x, impl="fused", mlp_impl="fused")
    assert log == ["fused_mlp"]


def test_selective_int8_policy_takes_the_int8_block_bodies(monkeypatch):
    blk, log = _meta_block(monkeypatch)
    x = torch.empty(2, 96, 512, device="meta")
    with torch.no_grad(), quant.matmul_impl("int8", min_cols=1024):
        blk(x, impl="fused", mlp_impl="fused")
    assert log == ["block_attn_int8", "block_mlp_int8"]


@pytest.mark.parametrize("min_cols", [1, 4096])
def test_non_selective_int8_policy_keeps_the_unfused_path(monkeypatch, min_cols):
    """min_cols 1 (every projection quantized) and 4096 (none) are not the
    selective policy: no block kernel, no int8 kernel. 1 matches the JAX
    block's unfused int8 path (1e-3 of max|JAX|, a flip allowed); 4096 is
    bit-identical to the per-module path in the default context."""
    rng = np.random.RandomState(73)
    x, kpad = _n(rng, 3, 64, C), _kpad(3, 64)
    blk = jblocks.ResidualAttentionBlock(width=C, heads=H)
    params = blk.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(kpad))["params"]
    enc = tblocks.TemporalEncoder(C, 1, H)
    enc.load_state_dict(encoder_state_dict_from_jax({"resblocks_0": params}), strict=True)
    log = _count_blocks(monkeypatch)
    with torch.no_grad():
        default = enc.resblocks[0](_t(x), _t(kpad))
        with quant.matmul_impl("int8", min_cols=min_cols):
            got = enc.resblocks[0](_t(x), _t(kpad), impl="fused", mlp_impl="fused")
    assert log == []
    if min_cols == 4096:
        for g, d in zip(got, default):
            assert torch.equal(g, d)
        return
    with jquant.matmul_impl("int8", min_cols=min_cols):
        want = blk.apply({"params": params}, jnp.asarray(x), jnp.asarray(kpad), impl="fused",
                         mlp_impl="fused")
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-3


def test_check_impl_admits_fused_and_refuses_small():
    """Both impls of the later slices pass ``check_impl``; 'small' is an
    attention core, never the whole-block path."""
    tattn.check_impl("fused")
    tattn.check_impl("small")
    assert tattn.block_fusion_mode("small", 64, 512, 8) is None
    assert tattn.block_fusion_mode("fused", 64, 512, 8) == "exact"


# ----------------------------------------------------------- guard rails
def _meta_args(c=512, requires_grad=False):
    x = torch.empty(2, 64, c, device="meta", requires_grad=requires_grad)
    ln = (torch.empty(c, device="meta"), torch.empty(c, device="meta"))
    attn = (torch.empty(3 * c, c, device="meta"), torch.empty(3 * c, device="meta"),
            torch.empty(c, c, device="meta"), torch.empty(c, device="meta"))
    mlp = (torch.empty(4 * c, c, device="meta"), torch.empty(4 * c, device="meta"),
           torch.empty(c, 4 * c, device="meta"), torch.empty(c, device="meta"))
    return x, ln, attn, mlp


@pytest.mark.parametrize("int8", [False, True])
def test_block_wrappers_check_before_any_launch(monkeypatch, int8):
    """On a card tensor the wrappers raise before any build on a LayerNorm
    of the wrong width and an input that requires grad; a head of 128 (C
    512, H 4), served by the wide-head body, passes the checks and reaches
    the C entry (a stand-in library records it)."""
    from tests.test_torch_mha_family import _fake_library

    calls = []
    _fake_library(monkeypatch, calls)
    x, ln, attn, mlp = _meta_args()
    with torch.no_grad():
        out, x_norm = tattn.fused_block_attn(x, None, *ln, *attn, 4, int8_qkv=int8)
    assert out.shape == x_norm.shape == x.shape
    ((fn, args),) = calls
    name = "block_attn_int8" if int8 else "block_attn"
    assert fn == f"{name}_forward" and args[-6:-2] == (2, 64, 512, 4)
    bad_ln = (torch.empty(256, device="meta"),) * 2
    with torch.no_grad(), pytest.raises(ValueError, match="LayerNorm"):
        tattn.fused_block_attn(x, None, *bad_ln, *attn, 8, int8_qkv=int8)
    with torch.no_grad(), pytest.raises(ValueError, match="LayerNorm"):
        tmlp.fused_block_mlp(x, *bad_ln, *mlp, int8_cfc=int8)
    xg, _, _, _ = _meta_args(requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        tattn.fused_block_attn(xg, None, *ln, *attn, 8, int8_qkv=int8)
    with pytest.raises(RuntimeError, match="inference-only"):
        tmlp.fused_block_mlp(xg, *ln, *mlp, int8_cfc=int8)


def test_int8_block_bodies_are_not_differentiable():
    """The int8 bodies raise under grad on the CPU too (the int8 product
    has no gradient); the exact ones differentiate there."""
    x, kpad, ln, weights = _attn_case(64, 5)
    tx = _t(x).requires_grad_()
    g, b = (_t(a) for a in ln)
    wi, bi, wo, bo = weights
    aw = (_t(wi.T), _t(bi), _t(wo.T), _t(bo))
    with pytest.raises(RuntimeError, match="inference-only"):
        tattn.fused_block_attn(tx, _t(kpad), g, b, *aw, H, int8_qkv=True)
    out, _ = tattn.fused_block_attn(tx, _t(kpad), g, b, *aw, H)
    out.sum().backward()
    assert tx.grad is not None and torch.isfinite(tx.grad).all()
    mw = tuple(_t(a) for a in _mlp_weights(np.random.RandomState(6)))
    with pytest.raises(RuntimeError, match="inference-only"):
        tmlp.fused_block_mlp(tx, g, b, mw[0].T, mw[1], mw[2].T, mw[3], int8_cfc=True)
