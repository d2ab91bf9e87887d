"""The PyTorch port's ops against the JAX package on the same inputs.

Inputs and weights come from numpy seeds and reach both sides as arrays (the
port through its weight bridge). The JAX side runs its Pallas kernels in
interpret mode (impl="fused"), as tests/test_attention.py does. On the CPU
the port's kernel wrappers take their plain PyTorch versions; the CUDA
kernels themselves are held against those on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.ops import attention as jattn
from exoground_tpu.ops import blocks as jblocks
from exoground_tpu.ops import fused_mlp as jmlp
from exoground_tpu.ops import pos_embed as jpos
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops import attention as tattn
from exoground_tpu_torch.ops import blocks as tblocks
from exoground_tpu_torch.ops import fused_mlp as tmlp
from exoground_tpu_torch.ops import pos_embed as tpos
from exoground_tpu_torch.utils.convert import encoder_state_dict_from_jax

ATOL, RTOL = 5e-5, 1e-4  # pos-embed, blocks and stage stack


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ pos embedding
def test_sine_table_matches_jax():
    np.testing.assert_allclose(
        tpos.get_position_embedding_sine(64, 300).numpy(),
        np.asarray(jpos.get_position_embedding_sine(64, 300)), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("true_len", [None, 150])
def test_interpolate_and_slice_match_jax(true_len):
    table = _n(np.random.RandomState(0), 256, 16)
    got = tpos.slice_or_interpolate_pos_embed(_t(table), 192, 64, true_len=true_len)
    want = jpos.slice_or_interpolate_pos_embed(jnp.asarray(table), 192, 64,
                                               true_len=true_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(
        tpos.slice_or_interpolate_pos_embed(_t(table), 40, start_idx=7).numpy(),
        np.asarray(jpos.slice_or_interpolate_pos_embed(jnp.asarray(table), 40,
                                                       start_idx=7)))


def test_random_pos_start_draws_from_generator():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = [tpos.random_pos_start(g1, 64) for _ in range(20)]
    assert a == [tpos.random_pos_start(g2, 64) for _ in range(20)]
    assert all(0 <= s < 32 for s in a) and len(set(a)) > 1
    assert tpos.random_pos_start(g1, 1) == 0


# ----------------------------------------------------------------- fused MHA
def _mha_weights(rng, c):
    return dict(in_proj_kernel=_n(rng, c, 3 * c, scale=c ** -0.5),
                in_proj_bias=_n(rng, 3 * c, scale=0.02),
                out_proj_kernel=_n(rng, c, c, scale=c ** -0.5),
                out_proj_bias=_n(rng, c, scale=0.02))


def _torch_mha(p):
    return (_t(p["in_proj_kernel"].T), _t(p["in_proj_bias"]),
            _t(p["out_proj_kernel"].T), _t(p["out_proj_bias"]))


@pytest.mark.parametrize("s", [33, 64, 72, 80, 96, 128])
def test_fused_mha_matches_jax_fused_kernel(s):
    """fused_mha (plain on the CPU) against the JAX module's Pallas whole-MHA
    kernel; the fully-masked window's rows against _mha_xla (the Pallas
    kernel averages across a packed neighbour window there, the port follows
    attention_xla)."""
    c, h, b = 128, 4, 3
    rng = np.random.RandomState(50 + s)
    x = _n(rng, b, s, c)
    p = _mha_weights(rng, c)
    kpad = np.zeros((b, s), bool)
    kpad[0] = True  # a padded group window
    kpad[1, int(s * 0.7):] = True
    want = np.asarray(jattn.MultiHeadAttention(num_heads=h).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
        jnp.asarray(kpad), impl="fused"))
    want_xla = np.asarray(jattn._mha_xla(
        jnp.asarray(x), jnp.asarray(kpad), *(jnp.asarray(p[k]) for k in (
            "in_proj_kernel", "in_proj_bias", "out_proj_kernel", "out_proj_bias")), h))
    got = tattn.fused_mha(_t(x), _t(kpad), *_torch_mha(p), h).numpy()
    np.testing.assert_allclose(got[1:], want[1:], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[0], want_xla[0], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("s", [33, 96, 128])
def test_fused_mha_bfloat16_matches_jax_fused_kernel(s):
    """In bfloat16, fused_mha's CPU path (mha_plain) against the JAX Pallas
    whole-MHA kernel in interpret mode, at windows the bf16 CUDA body's
    128-row tiles hold two of (S 33), or one with padding rows (S 96, 128).
    mha_plain rounds q, k, v and the normalised p to bf16 where the bf16
    CUDA body does; the JAX kernel keeps them in f32, so the two differ by
    those roundings (measured <= 6.3e-3 of max|JAX| over 3 seeds): limit
    1.5e-2 of max|JAX|. The fully-masked window against _mha_xla, as in the
    float32 test."""
    c, h, b = 128, 4, 3
    rng = np.random.RandomState(60 + s)
    x = _n(rng, b, s, c)
    p = _mha_weights(rng, c)
    kpad = np.zeros((b, s), bool)
    kpad[0] = True
    kpad[1, int(s * 0.7):] = True

    def jbf(a):
        return jnp.asarray(a, dtype=jnp.bfloat16)

    names = ("in_proj_kernel", "in_proj_bias", "out_proj_kernel", "out_proj_bias")
    want = np.asarray(jattn._fused_mha(jbf(x), jnp.asarray(kpad), *(jbf(p[k]) for k in names),
                                       h).astype(jnp.float32))
    want_xla = np.asarray(jattn._mha_xla(jbf(x), jnp.asarray(kpad),
                                         *(jbf(p[k]) for k in names), h).astype(jnp.float32))
    got = tattn.fused_mha(_t(x).bfloat16(), _t(kpad),
                          *(w.bfloat16() for w in _torch_mha(p)), h)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1.5e-2 * np.abs(want).max())
    np.testing.assert_allclose(got[0], want_xla[0], rtol=0,
                               atol=1.5e-2 * np.abs(want_xla[0]).max())


def test_fully_masked_window_averages_its_own_values():
    """A window whose keys are all padding attends uniformly over its OWN S
    values (attention_xla's finite -1e30 fill), never another window's."""
    c, h, s = 128, 4, 40
    rng = np.random.RandomState(7)
    x = _n(rng, 2, s, c)
    w_in, b_in, w_out, b_out = _torch_mha(_mha_weights(rng, c))
    kpad = torch.zeros(2, s, dtype=torch.bool)
    kpad[0] = True
    got = tattn.fused_mha(_t(x), kpad, w_in, b_in, w_out, b_out, h)
    v = torch.nn.functional.linear(_t(x[0]), w_in[2 * c:], b_in[2 * c:])
    want = torch.nn.functional.linear(v.mean(0), w_out, b_out)
    np.testing.assert_allclose(got[0].numpy(), want.expand(s, c).numpy(),
                               atol=1e-5, rtol=1e-5)
    # the other window is untouched by the masked one
    alone = tattn.fused_mha(_t(x[1:]), kpad[1:], w_in, b_in, w_out, b_out, h)
    np.testing.assert_allclose(got[1:].numpy(), alone.numpy(), atol=1e-6)


@pytest.mark.parametrize("kind", ["self", "kv", "separate"])
def test_module_unfused_paths_match_jax(kind):
    """Cross-attention and aliased inputs take the unfused composition with
    the JAX module's q/kv split; self-attention takes fused_mha."""
    c, h = 64, 4
    rng = np.random.RandomState(11)
    p = _mha_weights(rng, c)
    q = _n(rng, 2, 10, c)
    k = q if kind == "self" else _n(rng, 2, 7 if kind == "kv" else 10, c)
    v = k if kind in ("self", "kv") else _n(rng, 2, 10, c)
    kpad = np.zeros((2, k.shape[1]), bool)
    kpad[1, -3:] = True
    jq = jnp.asarray(q)
    jk = jq if kind == "self" else jnp.asarray(k)
    jv = jk if kind in ("self", "kv") else jnp.asarray(v)
    want = jattn.MultiHeadAttention(num_heads=h).apply(
        {"params": p}, jq, jk, jv, jnp.asarray(kpad), impl="xla")
    mod = tattn.MultiHeadAttention(c, h)
    mod.load_state_dict({"in_proj_weight": _t(p["in_proj_kernel"].T),
                         "in_proj_bias": _t(p["in_proj_bias"]),
                         "out_proj.weight": _t(p["out_proj_kernel"].T),
                         "out_proj.bias": _t(p["out_proj_bias"])})
    tq = _t(q)
    tk = tq if kind == "self" else _t(k)
    tv = tk if kind in ("self", "kv") else _t(v)
    with torch.no_grad():
        got = mod(tq, tk, tv, _t(kpad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("s,c,h,ok", [
    (64, 512, 8, True), (96, 512, 8, True), (128, 128, 4, True), (129, 512, 8, False),
    (64, 96, 3, False), (64, 512, 4, True), (64, 256, 32, True), (33, 128, 2, True),
])
def test_kernel_eligibility(s, c, h, ok):
    """The JAX dispatch test as it is (S <= 128, C % 128 == 0, Dh % 8 == 0);
    no row-count gate."""
    assert tattn.kernel_eligible(s, c, h) is ok


@pytest.mark.parametrize("c,h", [(512, 4), (256, 2)])
def test_module_raises_on_a_head_size_the_kernel_lacks(c, h):
    """An eligible self-attention off the CPU always goes to the kernel
    wrapper; a head size the CUDA kernel does not serve (> 64) raises there
    rather than taking the unfused composition. A meta tensor stands for a
    card's: it reaches the wrapper's checks and nothing runs."""
    mod = tattn.MultiHeadAttention(c, h).to("meta")
    x = torch.empty(2, 16, c, device="meta")
    with torch.no_grad(), pytest.raises(NotImplementedError, match="head size"):
        mod(x, x, x)


# ----------------------------------------------------------------- fused MLP
def _mlp_weights(rng, c):
    return (_n(rng, c, 4 * c, scale=0.02), _n(rng, 4 * c, scale=0.02),
            _n(rng, 4 * c, c, scale=0.02), _n(rng, c, scale=0.02))


def test_fused_mlp_matches_jax_fused_kernel():
    rng = np.random.RandomState(40)
    c = 128
    x = _n(rng, 3, 70, c)
    fck, fcb, prk, prb = _mlp_weights(rng, c)
    want = jmlp.fused_mlp(*(jnp.asarray(a) for a in (x, fck, fcb, prk, prb)))
    got = tmlp.fused_mlp(_t(x), _t(fck.T), _t(fcb), _t(prk.T), _t(prb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_mlp_module_routes_by_width(monkeypatch):
    """Widths that are multiples of 128 (the JAX test) go through fused_mlp,
    others through the plain composition; both equal the JAX MLP."""
    routed = []

    def spy(*args):
        routed.append(args[0].shape[-1])
        return tmlp.fused_mlp(*args)

    monkeypatch.setattr(tblocks, "fused_mlp", spy)
    for c in (64, 128, 640):
        rng = np.random.RandomState(c)
        fck, fcb, prk, prb = _mlp_weights(rng, c)
        x = _n(rng, 2, 9, c)
        want = jblocks.MLP(c).apply(
            {"params": {"c_fc": {"kernel": fck, "bias": fcb},
                        "c_proj": {"kernel": prk, "bias": prb}}},
            jnp.asarray(x), impl="xla")
        mod = tblocks.MLP(c)
        mod.load_state_dict({"c_fc.weight": _t(fck.T), "c_fc.bias": _t(fcb),
                             "c_proj.weight": _t(prk.T), "c_proj.bias": _t(prb)})
        with torch.no_grad():
            got = mod(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        assert tmlp.kernel_eligible(c) is (c % 128 == 0)
    assert routed == [128, 640]


# ------------------------------------------------- fused MLP kernel: the plan
@pytest.mark.parametrize("rows,c", [
    (19456, 512), (29184, 512),  # the serving groups' dual and joint towers
    (2048, 512), (2096, 512), (3322, 512),  # the global path
    (4096, 512), (8192, 512),  # grounding's video, text and decoder calls
    (1, 512), (1, 1280), (40, 1280), (300, 640), (210, 128), (77, 1024)])
def test_mlp_launch_plan(rows, c):
    """Row tiles of 64, slabs of min(C, 512), and a hidden split (a divisor
    of the 4C / 128 chunks): below a wave of 132 SMs the least split that
    reaches one, so at least a full wave wherever rows >= 2,048; from a wave
    up a split of at most 4 only where it cuts the waves per split by a
    tenth; 1 row and C 1280 are served."""
    plan = tmlp.mlp_launch_plan(rows, c, sms=132)
    chunks = 4 * c // 128
    tiles = -(-rows // plan["row_tile"])
    assert plan["row_tile"] == 64 and plan["slab"] == min(c, 512)
    assert plan["slabs"] * plan["slab"] >= c > (plan["slabs"] - 1) * plan["slab"]
    assert chunks % plan["split"] == 0
    assert plan["ctas"] == tiles * plan["slabs"] * plan["split"]
    if rows >= 2048:
        assert plan["ctas"] >= 132
    work = tiles * plan["slabs"]
    if work >= 132:
        waves = [-(-work * d // 132) / d for d in (1, plan["split"])]
        assert plan["split"] <= 4 and (plan["split"] == 1 or waves[1] <= 0.9 * waves[0])
    else:
        assert all(work * d < 132 for d in range(1, plan["split"]) if chunks % d == 0)


@pytest.mark.parametrize("rows,c", [(0, 512), (8, 500), (8, 64)])
def test_mlp_launch_plan_refuses_what_the_kernel_does_not_serve(rows, c):
    with pytest.raises(ValueError, match="multiple of 128"):
        tmlp.mlp_launch_plan(rows, c)


def _tf32(a):
    """float32 truncated to TF32 (10 mantissa bits): the kernel's bit mask
    for a_hi, and what the tensor core reads of an f32 operand."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a . b^T as the f32 kernel body computes it: each operand split as
    a_hi = a truncated to TF32, a_lo = a - a_hi truncated by the tensor core,
    a_lo b_hi + a_hi b_lo + a_hi b_hi (TF32 products are exact in float32),
    summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return sum((torch.from_numpy(x) @ torch.from_numpy(y).T).numpy()
               for x, y in ((al, bh), (ah, bl), (ah, bh)))


@pytest.mark.parametrize("c", [128, 512])
def test_three_tf32_mlp_keeps_float32_accuracy(c):
    """The numerics of the fused MLP's f32 body, emulated: both products in
    3xTF32 with the f32 bias and QuickGELU between them, against the MLP in
    float64. Its error is that of a float32 MLP, far below the 1e-4 limit
    of max|ref|; plain TF32 (a_hi b_hi alone) is not."""
    rng = np.random.RandomState(c)
    x = _n(rng, 64, c)
    fcw, fcb = _n(rng, 4 * c, c, scale=c ** -0.5), _n(rng, 4 * c, scale=0.02)
    prw, prb = _n(rng, c, 4 * c, scale=(4 * c) ** -0.5), _n(rng, c, scale=0.02)

    def gelu(h):
        return h / (1 + np.exp(-1.702 * h))

    ref = gelu(x.astype(np.float64) @ fcw.T.astype(np.float64) + fcb) @ prw.T.astype(
        np.float64) + prb
    h = gelu(_mm_3xtf32(x, fcw) + fcb).astype(np.float32)
    got = _mm_3xtf32(h, prw) + prb
    h1 = gelu((torch.from_numpy(_tf32(x)) @ torch.from_numpy(_tf32(fcw)).T).numpy() + fcb)
    tf32 = (torch.from_numpy(_tf32(h1.astype(np.float32)))
            @ torch.from_numpy(_tf32(prw)).T).numpy() + prb
    f32 = tmlp.mlp_plain(_t(x), _t(fcw), _t(fcb), _t(prw), _t(prb)).numpy()
    scale = np.abs(ref).max()
    err_3x, err_tf32, err_f32 = (np.abs(a - ref).max() / scale for a in (got, tf32, f32))
    assert err_3x <= 2e-6 and err_3x <= 4 * err_f32, (err_3x, err_f32)
    assert err_tf32 > 50 * err_3x, (err_tf32, err_3x)


# --------------------------------------------------------------------- blocks
@pytest.fixture(scope="module")
def encoder_pair():
    """A 2-layer width-128 JAX TemporalEncoder (fused impls) and the port's,
    on the same weights through the bridge."""
    c, layers, h = 128, 2, 4
    enc = jblocks.TemporalEncoder(c, layers, h)
    x0 = jnp.zeros((1, 8, c))
    params = jax.tree_util.tree_map(np.asarray,
                                    enc.init(jax.random.PRNGKey(0), x0))
    # non-trivial LayerNorms and biases
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + _n(rng, *a.shape, scale=0.05), params)
    port = tblocks.TemporalEncoder(c, layers, h)
    port.load_state_dict(encoder_state_dict_from_jax(params["params"]), strict=True)
    return enc, params, port


def test_block_returns_x_and_x_norm(encoder_pair):
    enc, params, port = encoder_pair
    rng = np.random.RandomState(2)
    x = _n(rng, 2, 24, 128)
    kpad = np.zeros((2, 24), bool)
    kpad[1, -5:] = True
    blk = jblocks.ResidualAttentionBlock(128, 4)
    want_x, want_n = blk.apply({"params": params["params"]["resblocks_0"]},
                               jnp.asarray(x), jnp.asarray(kpad),
                               impl="fused", mlp_impl="fused")
    with torch.no_grad():
        got_x, got_n = port.resblocks[0](_t(x), _t(kpad))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=ATOL, rtol=RTOL)


def test_encoder_stage_stack_matches_jax(encoder_pair):
    """(B, Stage, T, C): x_norm of layers 2..N then the final output."""
    enc, params, port = encoder_pair
    rng = np.random.RandomState(3)
    x = _n(rng, 2, 40, 128)
    kpad = np.zeros((2, 40), bool)
    kpad[0, -11:] = True
    want = enc.apply(params, jnp.asarray(x), jnp.asarray(kpad),
                     impl="fused", mlp_impl="fused")
    with torch.no_grad():
        got = port(_t(x), _t(kpad))
    assert got.shape == (2, 2, 40, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------- wrapper guard rails
def test_kernel_guards_on_cpu_tensors():
    """The checks the CUDA wrappers run before a launch."""
    w = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        _kernels.check_inference("fused_mlp", w)
    with torch.no_grad():
        _kernels.check_inference("fused_mlp", w)
    with pytest.raises(TypeError):
        _kernels.dtype_code(torch.zeros(2, dtype=torch.float16))
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.check_cuda_inputs("k", x.device, x.dtype, x=x.t()[:, :2])
    with pytest.raises(TypeError):
        _kernels.check_cuda_inputs("k", x.device, torch.bfloat16, x=x)
    assert _kernels.dtype_code(x) == 0
    assert _kernels.dtype_code(x.bfloat16()) == 1


def test_bfloat16_kernels_need_16_byte_aligned_operands():
    """The bf16 tensor-core bodies stage their operands by 16-byte cp.async;
    the wrappers name a misaligned operand before a launch."""
    fresh = torch.zeros(4, 64, dtype=torch.bfloat16)
    _kernels.check_aligned("flash_fwd", q=fresh, k=fresh[1:])  # a 128-byte row step
    with pytest.raises(ValueError, match="k must start on a 16-byte boundary"):
        _kernels.check_aligned("flash_fwd", q=fresh, k=fresh.view(-1)[4:].view(-1, 4))


def test_kernel_libraries_are_keyed_by_source():
    """A library name carries the hash of its sources and flags, so an edited
    kernel never loads a stale build; nothing is built at import."""
    paths = {n: _kernels._lib_path(n) for n in _kernels.SIGNATURES}
    assert all(p.parent == _kernels.BUILD_DIR for p in paths.values())
    assert len({p.name for p in paths.values()}) == len(paths)
    assert all((_kernels.CSRC / f"{n}.cu").exists() for n in paths)
    assert _kernels._libs == {}


def _fake_nvcc(tmp_path, monkeypatch, script):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_kernels, "_libs", {})


def test_kernel_build_failure_reports_nvcc_and_leaves_nothing(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'echo "error: no sm_90a here" >&2\nexit 3\n')
    with pytest.raises(RuntimeError, match=r"(?s)exit 3.*no sm_90a here"):
        _kernels.build()
    assert list((tmp_path / "kernels").iterdir()) == []
    assert _kernels._libs == {}


def test_kernel_build_names_the_library_by_source_hash(tmp_path, monkeypatch):
    """nvcc's output lands atomically under the hashed name; a file that is
    no shared library fails to load instead of being used."""
    # the fake compiler writes a non-library to the path after -o
    _fake_nvcc(tmp_path, monkeypatch,
               'while [ "$1" != "-o" ]; do shift; done\necho junk > "$2"\n')
    with pytest.raises(OSError):
        _kernels.build(["fused_mlp"])
    built = [p.name for p in (tmp_path / "kernels").iterdir()]
    assert built == [_kernels._lib_path("fused_mlp").name]
