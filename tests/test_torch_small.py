"""The port's window-attention core ('small') against the JAX package, on
the CPU.

Inputs come from numpy seeds and reach both sides as arrays. The JAX
``small_attention`` runs its Pallas kernel in interpret mode, as
tests/test_attention.py runs it; the port's CPU tensors take
``small_attention_plain``, the kernel body written plainly, which
chip_smoke.py (phase 3f) holds the CUDA kernel against on the card.
Tolerances: float32 1e-5 of max|JAX| (the same f32 softmax and
normalisation after the product, summed in another order), bfloat16 1e-2
(bf16 rounding of q after the scale and of p); modules and the aligner atol
2e-5 / rtol 1e-4, as tests/test_torch_flash.py holds them.

A fully-masked window is where the two differ by design: the port averages
the window's own values, as ``attention_xla`` does; the JAX kernel averages
the 128 columns of its packed tile (ROADMAP.md §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.ops import attention as jattn
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.ops import attention as tattn
from exoground_tpu_torch.utils.convert import load_tan_params
from tests.test_torch_flash import _mha_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(b, h, s, d, seed):
    return tuple(_rand(b, h, s, d, seed=seed + i) for i in range(3))


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


def jax_params(module, *args, seed=0, **kw):
    """Seeded numpy weights in ``module``'s JAX param tree (LayerNorm
    scales near 1, biases 0.02, kernels 1/sqrt(fan_in))."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 else sd.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _kpad(b, s, tail):
    kpad = np.zeros((b, s), bool)
    kpad[1, s - tail:] = True
    return kpad


# ------------------------------------------------------------------ the core
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d", [(16, 32), (16, 64), (64, 32), (64, 64), (96, 32), (96, 64),
                                 (128, 32), (128, 64)])
def test_small_attention_matches_jax(s, d, dtype):
    """B2 H2 with a padded key tail in batch row 1; every window keeps a
    valid key."""
    q, k, v = _qkv(2, 2, s, d, seed=s + d)
    kpad = _kpad(2, s, s // 3)
    want = jattn.small_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(kpad))
    got = tattn.small_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(kpad))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 2, s, d)
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)


def test_no_cross_window_leakage():
    """As tests/test_attention.py::test_no_cross_window_leakage: window 0's
    output is bitwise independent of window 1's content."""
    b, h, s, d = 2, 1, 64, 32
    q, k, v = (_t(a) for a in _qkv(b, h, s, d, seed=26))
    out1 = tattn.small_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[1] *= -3.0
    v2[1] += 7.5
    out2 = tattn.small_attention(q, k2, v2)
    assert torch.equal(out1[0], out2[0])
    assert (out1[1] - out2[1]).abs().max() > 1e-3


@pytest.mark.parametrize("s", [64, 96])
def test_fully_masked_window_averages_its_own_values(s):
    """Window 0 fully masked: the port equals ``attention_xla`` there (the
    mean of its own values) and the JAX kernel elsewhere; the JAX kernel
    averages its packed tile there (the neighbour window at S 64, zero
    padding over 128 at S 96), so the two differ on that window only."""
    b, h, d = 2, 2, 32
    q, k, v = _qkv(b, h, s, d, seed=40 + s)
    kpad = np.zeros((b, s), bool)
    kpad[0] = True
    kpad[1, s - 5:] = True
    jk = jnp.asarray(kpad)
    got = tattn.small_attention(_t(q), _t(k), _t(v), _t(kpad)).numpy()
    jax_small = np.asarray(jattn.small_attention(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), jk))
    jax_xla = np.asarray(jattn.attention_xla(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), jk))
    np.testing.assert_allclose(got[0], jax_xla[0], atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True),
                                                       got[0].shape), atol=1e-6, rtol=1e-5)
    assert _rel(got[1], jax_small[1]) <= TOL["float32"]
    assert np.abs(got[0] - jax_small[0]).max() > 1e-2
    assert np.isfinite(got).all()


def test_gradients_on_the_cpu_match_jax():
    """The plain version is differentiable on the CPU; the JAX custom VJP
    runs ``attention_xla`` both ways (attention.py:543-558), so the two agree
    at the flash gradient tolerance of tests/test_torch_flash.py."""
    b, h, s, d = 2, 2, 64, 32
    q, k, v = _qkv(b, h, s, d, seed=29)
    kpad = np.zeros((b, s), bool)
    kpad[0, 50:] = True
    jk = jnp.asarray(kpad)
    want = jax.grad(lambda q, k, v: jnp.sum(jattn.small_attention(q, k, v, jk) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (tattn.small_attention(tq, tk, tv, _t(kpad)) ** 2).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


def test_wrapper_refuses_unserved_shapes_and_grad_on_the_card():
    """Every head size is served, as by the JAX function: at 136 and 60,
    seeded q, k, v and a ragged key padding give on the CPU the float64
    softmax(q k^T / sqrt(D), padding keys excluded) v within 1e-5 of its
    max; a non-square or longer window raises in the wrapper (the
    dispatcher never sends one); on a card tensor (meta stands for it) an
    input that requires grad raises before any build."""
    for d in (136, 60):
        q, k, v = _qkv(2, 2, 16, d, seed=d)
        pad = np.arange(16)[None, :] >= np.array([[5], [16]])
        got = tattn.small_attention(_t(q), _t(k), _t(v), torch.from_numpy(pad)).numpy()
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(d)
        s = np.where(pad[:, None, None, :], -np.inf, s)
        p = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
        assert got.shape == q.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="S <= 128"):
        z = torch.zeros(1, 2, 130, 64)
        tattn.small_attention(z, z, z)
    with pytest.raises(ValueError, match="S <= 128"):
        tattn.small_attention(torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 16, 64),
                              torch.zeros(1, 2, 16, 64))
    m = torch.empty(2, 8, 64, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        tattn.small_attention(m, m, m)


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 64), (64, 32), (160, 160)])
def test_dispatcher_matches_jax(monkeypatch, sq, sk):
    """scaled_dot_attention(impl='small') against the JAX dispatcher: a
    square window of S <= 128 takes the window core, a non-square or longer
    one ``attention_plain`` (attention.py:1016-1017)."""
    routed = []
    for name in ("small_attention", "attention_plain"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name,
                            lambda *a, _n=name, _f=real, **kw: routed.append(_n) or _f(*a, **kw))
    q, k, v = _rand(2, 2, sq, 16, seed=35), _rand(2, 2, sk, 16, seed=36), \
        _rand(2, 2, sk, 16, seed=37)
    kpad = _kpad(2, sk, 4)
    want = jattn.scaled_dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(kpad), impl="small")
    got = tattn.scaled_dot_attention(_t(q), _t(k), _t(v), _t(kpad), impl="small")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    assert routed[0] == ("small_attention" if sq == sk <= 128 else "attention_plain")


@pytest.mark.parametrize("kind,sk", [("self", 64), ("cross", 64), ("cross", 40)])
def test_mha_module_small_matches_jax(kind, sk):
    """MultiHeadAttention(impl='small') against the JAX module: the unfused
    projections (``mha_plain`` for self-attention, the q/kv split for
    cross-attention) and the window core on square windows."""
    c, h, s = 128, 4, 64
    rng = np.random.RandomState(31)
    p = _mha_params(rng, c)
    x = rng.standard_normal((3, s, c)).astype(np.float32)
    mem = rng.standard_normal((3, sk, c)).astype(np.float32)
    kv = x if kind == "self" else mem
    kpad = np.zeros((3, kv.shape[1]), bool)
    kpad[2, kv.shape[1] - 9:] = True
    jx, jm = jnp.asarray(x), jnp.asarray(kv)
    jkv = jx if kind == "self" else jm
    want = jattn.MultiHeadAttention(num_heads=h).apply({"params": p}, jx, jkv, jkv,
                                                       jnp.asarray(kpad), impl="small")
    mod = tattn.MultiHeadAttention(c, h)
    mod.load_state_dict({"in_proj_weight": _t(p["in_proj_kernel"].T),
                         "in_proj_bias": _t(p["in_proj_bias"]),
                         "out_proj.weight": _t(p["out_proj_kernel"].T),
                         "out_proj.bias": _t(p["out_proj_bias"])})
    tx = _t(x)
    tkv = tx if kind == "self" else _t(kv)
    with torch.no_grad():
        got = mod(tx, tkv, tkv, _t(kpad), impl="small")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_aligner_small_text_visual_sim_matches_jax():
    """TemporalAligner(attn_impl='small').text_visual_sim against the JAX
    model's at a small width: both towers' windows (S 64 and 64 + 16) through
    the window core."""
    arch = dict(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4, input_dim=64,
                max_pos=128)
    jm = JaxAligner(**arch, attn_impl="small")
    params = {"params": jax_params(jm, jnp.zeros((1, 8, 64)), jnp.zeros((1, 2, 64)),
                                   jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool), seed=9)}
    video, text = _rand(2, 64, 64, seed=1), _rand(2, 16, 64, seed=2)
    vmask = np.zeros((2, 64), bool)
    vmask[1, 50:] = True
    lmask = np.zeros((2, 16), bool)
    lmask[0, 12:] = True
    want = jm.apply(params, jnp.asarray(video), jnp.asarray(text),
                    video_padding_mask=jnp.asarray(vmask), lang_padding_mask=jnp.asarray(lmask),
                    method=JaxAligner.text_visual_sim)
    tm = TemporalAligner(**arch, attn_impl="small", device="cpu")
    load_tan_params(tm, params)
    with torch.no_grad():
        got = tm.text_visual_sim(_t(video), _t(text), video_padding_mask=_t(vmask),
                                 lang_padding_mask=_t(lmask))
    for key in ("sim", "dual-sim"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5,
                                   rtol=1e-4, err_msg=key)


# ------------------------------------------ strided windows of a packed qkv
def _packed_views(qkv, h):
    """mha_plain's head split of a packed (B, S, 3C) qkv: three (B, H, S, D)
    views with strides (S*3C, D, 3C, 1), no copy."""
    return tuple(tattn._split_heads(t, h) for t in qkv.chunk(3, dim=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,d", [(2, 4, 64, 32), (3, 2, 17, 8), (2, 8, 100, 40),
                                     (1, 2, 96, 64)])
def test_window_strides_of_packed_and_contiguous_tensors(b, h, s, d, dtype):
    """The strides the window kernel is handed: the packed views where they
    lie, a contiguous (B, H, S, D) tensor, the (B, S, H, D) memory of the
    kernel's output; the stride of a size-1 dimension is 0."""
    c = h * d
    qkv = torch.zeros(b, s, 3 * c, dtype=getattr(torch, dtype))
    for t in _packed_views(qkv, h):
        assert not t.is_contiguous()
        assert list(tattn._window_strides(t)) == [s * 3 * c if b > 1 else 0, d, 3 * c]
    dense = torch.zeros(b, h, s, d, dtype=getattr(torch, dtype))
    assert list(tattn._window_strides(dense)) == [h * s * d if b > 1 else 0, s * d, d]
    out = torch.zeros(b, s, h, d, dtype=getattr(torch, dtype)).transpose(1, 2)
    assert list(tattn._window_strides(out)) == [s * h * d if b > 1 else 0, d, h * d]


@pytest.mark.parametrize("case", ["strided_head_dim", "unaligned_base", "unaligned_row_pitch",
                                  "unaligned_head_pitch", "not_4d"])
def test_window_strides_reject_what_the_kernel_cannot_read(case):
    """A view whose last dimension is strided, or whose base or pitches are
    not 16-byte aligned, raises ValueError: no hidden copy on the card."""
    if case == "strided_head_dim":
        t = torch.zeros(2, 2, 64, 16).transpose(2, 3)
        match = "head dimension must be contiguous"
    elif case == "unaligned_base":
        t = torch.zeros(2 * 2 * 16 * 64 + 1)[1:].view(2, 2, 16, 64)
        match = "16-byte aligned"
    elif case == "unaligned_row_pitch":
        t = torch.zeros(2, 2, 16, 66)[..., :64]  # 264-byte rows
        match = "16-byte aligned"
    elif case == "unaligned_head_pitch":
        t = torch.zeros(2, 16, 2 * 12, dtype=torch.bfloat16).reshape(2, 16, 2, 12).transpose(1, 2)
        match = "16-byte aligned"
    else:
        t = torch.zeros(2, 16, 64)
        match = r"\(B, H, S, D\)"
    with pytest.raises(ValueError, match=match):
        tattn._window_strides(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d", [(64, 32), (17, 8), (100, 40), (33, 128)])
def test_dispatcher_on_packed_qkv_views_matches_jax(s, d, dtype):
    """scaled_dot_attention(impl='small') on the non-contiguous views of a
    packed qkv (what mha_plain hands the window core) against the JAX
    dispatcher on the same values: a fully-masked window is left out, where
    the two differ by design (test above); ragged key tails are in."""
    b, h = 2, 2
    c = h * d
    qkv = _rand(b, s, 3 * c, seed=s + d)
    parts = [qkv[..., i * c:(i + 1) * c].reshape(b, s, h, d).transpose(0, 2, 1, 3)
             for i in range(3)]
    kpad = _kpad(b, s, s // 3)
    want = jattn.scaled_dot_attention(*(_j(p, dtype) for p in parts), jnp.asarray(kpad),
                                      impl="small")
    views = _packed_views(_t(qkv, dtype), h)
    assert not any(t.is_contiguous() for t in views)
    got = tattn.scaled_dot_attention(*views, _t(kpad), impl="small")
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, s, d)
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)
