"""The port's grounding family against the JAX package's and the golden
fixtures, on the CPU.

Weights come from numpy seeds drawn into the JAX param trees and reach the
port through its weight bridge (``utils/convert.py::
grounding_state_dict_from_jax``); inputs from numpy seeds reach both sides
as arrays. Under attn_impl='small' the JAX window kernel runs in interpret
mode and the port takes ``small_attention_plain``. Tolerances: modules and
models atol 2e-5 / rtol 1e-4 (tests/test_torch_flash.py), the golden
fixtures their tests/test_golden.py limits (2e-4 of max|ref| for the
grounding forward, 2e-5 for the VI encoder), the services 1e-5 of
max|JAX|, the JAX int8 service run eagerly (under jit its quantizer
multiplies by the reciprocal of 127, tests/test_torch_quant.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.losses import infonce as jinfonce
from exoground_tpu.models import vi_encoder as jvi
from exoground_tpu.models.grounding import ExoGroundingTransformer as JaxExo
from exoground_tpu.models.grounding import GroundingModel as JaxGrounding
from exoground_tpu.ops import blocks as jblocks
from exoground_tpu.serve import GroundingService as JaxService
from exoground_tpu.utils.convert import (
    convert_exoground_state_dict,
    convert_grounding_state_dict,
    convert_vi_encoder_state_dict,
)
from exoground_tpu_torch.evals.bench_items import make_grounding_requests
from exoground_tpu_torch.losses import info_nce_diag, pairwise_view_info_nce
from exoground_tpu_torch.models import ExoGroundingTransformer, GroundingModel
from exoground_tpu_torch.models.vi_encoder import ViewInvariantEncoder, ViewInvariantMLP
from exoground_tpu_torch.ops import blocks as tblocks
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.serve import GroundingService
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    encoder_state_dict_from_jax,
    grounding_state_dict_from_jax,
    load_grounding_params,
    load_reference_state,
)
from tests import golden_common as G
from tests.test_torch_small import jax_params as _params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

C, H = 128, 4
CLOSE = dict(atol=2e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, r):
    return np.abs(np.asarray(a) - r).max() / (np.abs(r).max() + 1e-8)


def _masks(b, t, n):
    vmask = np.zeros((b, t), bool)
    vmask[1, t - 5:] = True
    lmask = np.zeros((b, n), bool)
    lmask[0, n - 3:] = True
    return vmask, lmask


def _golden(name, seed):
    z = np.load(os.path.join(G.GOLDEN_DIR, name))
    return z, G.synth_state(G.manifest_from_npz(z), seed=seed)


# ---------------------------------------------------------------- decoder
@pytest.mark.parametrize("impl", ["xla", "small"])
@pytest.mark.parametrize("t", [16, 24])
def test_temporal_decoder_matches_jax(impl, t):
    """TemporalDecoder (and so ResidualDecoderBlock) against the JAX stack:
    its stages (x_norm of layers 2..N, then the output); a 16-frame memory
    makes the cross-attention square (the window core under 'small'), a
    24-frame one takes attention_plain."""
    rng = np.random.RandomState(t)
    x = rng.standard_normal((2, 16, C)).astype(np.float32)
    mem = rng.standard_normal((2, t, C)).astype(np.float32)
    mmask, tmask = _masks(2, t, 16)
    jdec = jblocks.TemporalDecoder(C, 2, H)
    args = (jnp.asarray(x), jnp.asarray(mem), jnp.asarray(tmask), jnp.asarray(mmask))
    params = _params(jdec, *args, seed=1)
    want = jdec.apply({"params": params}, *args, impl=impl)
    dec = tblocks.TemporalDecoder(C, 2, H)
    dec.load_state_dict(encoder_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = dec(_t(x), _t(mem), _t(tmask), _t(mmask), impl=impl)
        blk = dec.resblocks[0](_t(x), _t(mem), _t(tmask), _t(mmask), impl=impl)
    assert got.shape == (2, 2, 16, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    want_blk = jblocks.ResidualDecoderBlock(C, H).apply(
        {"params": params["resblocks_0"]}, *args, impl=impl)
    for g, w in zip(blk, want_blk):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CLOSE)


# ----------------------------------------------------------------- InfoNCE
def test_info_nce_matches_jax():
    rng = np.random.RandomState(3)
    f, p = rng.standard_normal((3, 10, 16)), rng.standard_normal((3, 10, 16))
    f, p = f.astype(np.float32), p.astype(np.float32)
    want = float(jinfonce.info_nce_diag(jnp.asarray(f), jnp.asarray(p)))
    np.testing.assert_allclose(float(info_nce_diag(_t(f), _t(p))), want, rtol=1e-5)
    feats = rng.standard_normal((4, 3 * 6, 16)).astype(np.float32)
    for vm in (np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1], [1, 0, 0]], bool),
               np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], bool)):
        want = float(jinfonce.pairwise_view_info_nce(jnp.asarray(feats), jnp.asarray(vm), 3))
        got = float(pairwise_view_info_nce(_t(feats), _t(vm), 3))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------- VI encoders
def test_vi_mlp_matches_jax():
    d = 48
    video = np.random.RandomState(4).standard_normal((2, 12, d)).astype(np.float32)
    jm = jvi.ViewInvariantMLP(video_embed_dim=d)
    params = _params(jm, jnp.asarray(video), seed=2)
    want = jm.apply({"params": params}, jnp.asarray(video))
    m = ViewInvariantMLP(d, device="cpu")
    state = grounding_state_dict_from_jax({"trunk": {}, "vi_encoder": params})
    m.load_state_dict({k[len("vi_encoder."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = m(_t(video))
    for key in ("low_dim_features", "high_dim_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **CLOSE)


def test_vi_encoder_matches_jax_and_golden():
    """The transformer VI encoder (two views stitched, the pos slice tiled
    per view) against the JAX module on the golden fixture's weights, and
    against the reference outputs (tests/test_golden.py:257-282). Its head
    size, 32 / 8 = 4, is below the window kernel's 8, so 'xla'; under
    'small' it runs in test_grounding_model_matches_jax."""
    z, state = _golden("vi_forward.npz", 13)
    kw = dict(num_encoder_layers=2, random_pos_start=0, video_embed_dim=48, feature_dim=32,
              use_distill_nce_loss=True, num_max_views=2, attn_impl="xla")
    video, ego = G.vi_encoder_inputs()
    b, t = video.shape[:2]
    m = ViewInvariantEncoder(**kw, device="cpu")
    m.load_state_dict({k: _t(v) for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = m(_t(video), None, torch.zeros((b, t), dtype=torch.bool))
    want = jvi.ViewInvariantEncoder(**kw).apply(
        {"params": convert_vi_encoder_state_dict(state)}, jnp.asarray(video), None,
        jnp.zeros((b, t), bool), None, egocentric_video_embed=jnp.asarray(ego))
    for key in ("low_dim_features", "high_dim_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **CLOSE)
        assert _rel(got[key].numpy(), z[f"out::{key}"]) < 2e-5, key


# ------------------------------------------------------------------ trunk
ARCH = dict(num_encoder_layers=2, num_decoder_layers=2, feature_dim=C, heads=H,
            video_embed_dim=48, text_embed_dim=40, audio_embed_dim=24, max_pos=64)
VARIANTS = {
    "base": {},
    "no_decoder": dict(use_decoder=False),
    "text_pos_enc": dict(use_text_pos_enc=1),
    "audio": dict(use_audio=True),
    "multi_view": dict(multi_view=True, num_max_views=2, use_pairwise_distill_nce_loss=True),
}


def _trunk_inputs(variant, b=2, t=16, n=16):
    rng = np.random.RandomState(5)
    vmask, lmask = _masks(b, t, n)
    args = [rng.standard_normal((b, t, 48)).astype(np.float32),
            rng.standard_normal((b, n, 40)).astype(np.float32), vmask, lmask]
    kw = {}
    if variant == "audio":
        kw = dict(audio_embed=rng.standard_normal((b, t, 24)).astype(np.float32),
                  audio_padding_mask=vmask)
    return args, kw


def _compare(got, want, keys):
    for key in keys:
        assert got[key].shape == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), **CLOSE,
                                   err_msg=key)


@pytest.mark.parametrize("variant,impl", [(v, "xla") for v in VARIANTS]
                         + [("base", "small"), ("multi_view", "small")])
def test_exoground_transformer_matches_jax(variant, impl):
    """E2D2, width 128, 4 heads; 16 frames and 16 narrations, so every
    window of the forward (16, 16 and the joint 32, the decoder's self- and
    cross-attention) is square under 'small'. Each option under 'xla'; the
    base and the multi-view model under 'small' too (the JAX window kernel
    in interpret mode costs ~7 s a forward)."""
    fields = dict(ARCH, **VARIANTS[variant])
    args, kw = _trunk_inputs(variant)
    jm = JaxExo(**fields, attn_impl=impl)
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = _params(jm, *jargs, **jkw, seed=6)
    want = jm.apply({"params": params}, *jargs, **jkw, deterministic=True)
    tm = ExoGroundingTransformer(**fields, attn_impl=impl, device="cpu")
    load_grounding_params(tm, params)
    with torch.no_grad():
        got = tm(*(_t(a) for a in args), **{k: _t(v) for k, v in kw.items()})
    assert set(got) == set(want)
    _compare(got, want, want)


@pytest.mark.parametrize("vi,impl,options", [
    ("mlp", "small", dict(use_distill_nce_loss=True)),
    ("transformer", "xla", dict(multi_view=True, num_max_views=2,
                                use_pairwise_distill_nce_loss=True,
                                pairwise_distill_mode="unmasked")),
    ("none", "xla", {}),
])
def test_grounding_model_matches_jax(vi, impl, options):
    """GroundingModel behind each VI pre-pass against the JAX model, with
    its distillation InfoNCE (diagonal against an egocentric target, or
    pairwise across two stitched views); the served configuration (the MLP
    pre-pass) under 'small'."""
    fields = dict(vi_encoder_type=vi, num_encoder_layers=2, num_decoder_layers=1,
                  feature_dim=C, video_embed_dim=48, text_embed_dim=40, attn_impl=impl,
                  **options)
    args, _ = _trunk_inputs("base")
    ego = np.random.RandomState(8).standard_normal((2, 16, 48)).astype(np.float32)
    kw = dict(egocentric_video_embed=ego) if options.get("use_distill_nce_loss") else {}
    jm = JaxGrounding(**fields)
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = _params(jm, *jargs, **jkw, seed=7)
    want = jm.apply({"params": params}, *jargs, **jkw, deterministic=True)
    tm = GroundingModel(**fields, device="cpu")
    load_grounding_params(tm, params)
    with torch.no_grad():
        got = tm(*(_t(a) for a in args), **{k: _t(v) for k, v in kw.items()})
    assert set(got) == set(want)
    _compare(got, want, want)


# ----------------------------------------------- golden fixture and bridge
def test_golden_exoground_forward_loads_by_reference_names():
    """The reference outputs of tests/test_golden.py:138-160 from the
    synth_state weights (seed 11) loaded with strict=True as they are."""
    z, state = _golden("exoground_forward.npz", 11)
    m = ExoGroundingTransformer(num_encoder_layers=2, num_decoder_layers=2, video_embed_dim=64,
                                text_embed_dim=64, feature_dim=128, attn_impl="xla",
                                device="cpu").eval()
    m.load_state_dict({k: _t(v) for k, v in state.items()}, strict=True)
    with torch.no_grad():
        out = m(*(_t(a) for a in G.exoground_inputs()), deterministic=True)
    r = z["out::interval_preds"]
    assert out["interval_preds"].shape == r.shape
    assert _rel(out["interval_preds"].numpy(), r) < 2e-4


def _vi_mlp_state(d=64, seed=12):
    rng = np.random.RandomState(seed)
    return {"video_pre_proj.weight": rng.standard_normal((d, d)).astype(np.float32),
            "ln_video_init.weight": rng.standard_normal(d).astype(np.float32),
            "ln_video_init.bias": rng.standard_normal(d).astype(np.float32),
            **{f"mlp.{i}.{p}": rng.standard_normal((d, d) if p == "weight" else d)
               .astype(np.float32) for i in (0, 2) for p in ("weight", "bias")}}


@pytest.mark.parametrize("vi", ["none", "mlp", "transformer"])
def test_bridge_is_the_inverse_of_convert(vi):
    """convert_exoground_state_dict (a trunk) or convert_grounding_state_dict
    (the trunk with ``vi_encoder.*``, MLP or transformer) of a
    reference-layout state, then grounding_state_dict_from_jax, gives back
    every array, under the names the port's models hold (the reference's
    unused ``mlp`` has no JAX counterpart)."""
    _, state = _golden("exoground_forward.npz", 11)
    kw = dict(num_encoder_layers=2, num_decoder_layers=2, video_embed_dim=64,
              text_embed_dim=64, feature_dim=128, device="cpu")
    if vi == "none":
        back = grounding_state_dict_from_jax({"params": convert_exoground_state_dict(state)})
        held = set(ExoGroundingTransformer(**kw).state_dict())
    else:
        if vi == "mlp":
            vi_state = _vi_mlp_state()
            vi_held = set(ViewInvariantMLP(64, device="cpu").state_dict())
        else:  # the fixture's VI encoder, 48 -> 32 wide
            _, vi_state = _golden("vi_forward.npz", 13)
            vi_held = set(ViewInvariantEncoder(video_embed_dim=48, feature_dim=32,
                                               device="cpu").state_dict())
        state = {**state, **{f"vi_encoder.{k}": v for k, v in vi_state.items()}}
        back = grounding_state_dict_from_jax({"params": convert_grounding_state_dict(state)})
        held = set(ExoGroundingTransformer(**kw).state_dict()) | {
            f"vi_encoder.{k}" for k in vi_held}
    assert set(back) == held - set(UNUSED_REFERENCE_KEYS)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_reference_checkpoint_loads_strictly(tmp_path):
    """A reference GroundingModel .pth.tar ('module.' prefix, the trunk
    inlined, ``vi_encoder.*``) loads into the port's model as it is."""
    _, state = _golden("exoground_forward.npz", 11)
    state = {**state, **{f"vi_encoder.{k}": v for k, v in _vi_mlp_state().items()}}
    path = tmp_path / "grounding.pth.tar"
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": _t(v) for k, v in state.items()}},
               path)
    loaded = load_reference_state(str(path))
    assert set(loaded) == set(state)
    model = GroundingModel(num_encoder_layers=2, num_decoder_layers=2, video_embed_dim=64,
                           text_embed_dim=64, feature_dim=128, device="cpu")
    model.load_state_dict(loaded, strict=True)
    np.testing.assert_array_equal(model.vi_encoder.mlp[2].bias.detach().numpy(),
                                  state["vi_encoder.mlp.2.bias"])


# ----------------------------------------------------------------- service
SVC = dict(num_encoder_layers=1, num_decoder_layers=1, feature_dim=32, heads=4,
           video_embed_dim=24, text_embed_dim=16, max_pos=64, random_pos_start=0)


@pytest.fixture(scope="module")
def services():
    """The JAX and the port's services on the same weights, 'small'
    everywhere (16-frame windows, narrations bucketed by 8)."""
    jm = JaxExo(**SVC, attn_impl="small")
    params = _params(jm, jnp.zeros((1, 16, 24)), jnp.zeros((1, 8, 16)),
                     jnp.zeros((1, 16), bool), jnp.zeros((1, 8), bool), seed=9)
    tm = ExoGroundingTransformer(**SVC, attn_impl="small", device="cpu")
    load_grounding_params(tm, params)
    out = {}
    for dtype in ("default", "int8"):
        if dtype == "default":
            jsvc = JaxService(jm, {"params": params}, seq_len=16, text_bucket=8)
        else:
            # eager: under jit XLA multiplies by the reciprocal of 127, one
            # ulp off the port's IEEE quotient (tests/test_torch_quant.py);
            # the 'xla' core keeps the eager run short and differs from the
            # window core by rounding only
            jsvc = JaxService(JaxExo(**SVC, attn_impl="xla"), {"params": params}, seq_len=16,
                              text_bucket=8, matmul_dtype=dtype)
            jsvc._run = jsvc._run.__wrapped__
        out[dtype] = (jsvc, GroundingService(tm, seq_len=16, text_bucket=8, matmul_dtype=dtype,
                                             device="cpu"))
    return out


def _requests():
    reqs = make_grounding_requests(3, 5, video_dim=24, text_dim=16, max_t=16, max_k=11)
    reqs[0]["video"] = reqs[0]["video"][:7]  # a short video in every run
    return reqs


@pytest.mark.parametrize("matmul_dtype", ["default", "int8"])
def test_ground_batch_matches_jax(services, matmul_dtype):
    """ground_batch over mixed buckets (K <= 8 and 9..11; the int8 mode,
    whose JAX reference runs eagerly, one bucket) and video lengths against
    the JAX service's, both protocols; ground() equals its row."""
    jsvc, svc = services[matmul_dtype]
    reqs = _requests()
    buckets = {-(-len(r["narration_embeds"]) // 8) for r in reqs}
    assert len(buckets) == 2
    if matmul_dtype == "int8":
        reqs = [r for r in reqs if len(r["narration_embeds"]) <= 8]
    tol = 1e-5
    for ucd in (True, False):
        got = svc.ground_batch(reqs, use_center_duration=ucd)
        want = jsvc.ground_batch(reqs, use_center_duration=ucd)
        scale = max(np.abs(w[k]).max() for w in want for k in ("start", "end"))
        for g, w, r in zip(got, want, reqs):
            assert len(g["start"]) == len(r["narration_embeds"])
            for k in ("start", "end"):
                assert np.abs(np.asarray(g[k]) - w[k]).max() <= tol * scale
    one = svc.ground(reqs[1]["video"], reqs[1]["narration_embeds"])
    np.testing.assert_allclose(one["start"], svc.ground_batch(reqs)[1]["start"], atol=1e-6)


def test_int8_service_quantizes_and_leaves_no_context(services):
    reqs = _requests()
    exact = services["default"][1].ground_batch(reqs)
    q = services["int8"][1].ground_batch(reqs)
    assert quant.current_impl() == "default"
    assert q != exact
    scale = max(np.abs(e["start"]).max() for e in exact)
    for a, b in zip(q, exact):  # within int8 noise of the exact answers
        assert np.abs(np.asarray(a["start"]) - b["start"]).max() <= 5e-2 * scale


def test_service_rejects_long_videos_and_bad_matmul_dtype(services):
    svc = services["default"][1]
    video = np.zeros((17, 24), np.float32)
    narr = np.zeros((3, 16), np.float32)
    with pytest.raises(ValueError, match="17 frames"):
        svc.ground(video, narr)
    with pytest.raises(ValueError, match="request 1"):
        svc.ground_batch([{"video": video[:4], "narration_embeds": narr},
                          {"video": video, "narration_embeds": narr}])
    with pytest.raises(ValueError, match="matmul_dtype"):
        GroundingService(svc.model, matmul_dtype="int5", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GroundingService(svc.model)
