"""The port's feature-extraction tool against the JAX package's, on the CPU.

* ``extract_video_features`` against the JAX harness (tests/
  test_tools.py:178-208) on the same frames, the encoder written once in each
  framework on the same weights (a pooled-pixel projection, then a
  LayerNorm): float16 output, 37 frames -> 37 rows at fps 1 in buckets of
  16 (the last one ragged), 4 rows at fps 8, each within 1e-2 of
  max|JAX| (the bf16 product rounds apart in XLA and PyTorch, the LayerNorm
  runs in float32 on both sides); float32 (``half=False``) within one
  float16 step of max|JAX| (2^-10 of it: the float32 results round to
  float16 either side of a step).
* The set of tensors the cast keeps in float32 equals the JAX cast's set on
  the aligner's and on S3D's converted parameters (S3D's BatchNorm scale
  kept, its bias cast, its running stats cast): the JAX cast's dtypes mapped
  to the port's names through the port's converters; and the JAX name the
  cast reads (``utils/convert.py::jax_name``) of every tensor each converter
  gives (aligner, grounding model with either pre-pass, S3D) is the path of
  the JAX leaf it was converted from.
* ``decode_frames`` and ``probe_duration`` return None without ffmpeg;
  ``extract_corpus`` writes a file a video, skips what exists and what does
  not decode.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models.grounding import GroundingModel as JaxGrounding
from exoground_tpu.tools import ExtractConfig as JaxExtractConfig
from exoground_tpu.tools import bf16_params_keep_layernorm as jax_cast
from exoground_tpu.tools import extract_video_features as jax_extract
from exoground_tpu.utils.convert import convert_s3d_state_dict as jax_convert_s3d
from exoground_tpu_torch.models import GroundingModel, TemporalAligner
from exoground_tpu_torch.models.s3d import S3D
from exoground_tpu_torch.tools import (
    ExtractConfig,
    bf16_params_keep_layernorm,
    decode_frames,
    extract_corpus,
    extract_video_features,
    probe_duration,
)
from exoground_tpu_torch.tools.synth_htm_aa import s3d_reference_state
from exoground_tpu_torch.utils.convert import (
    convert_s3d_state_dict,
    grounding_state_dict_from_jax,
    jax_name,
    load_tan_params,
    s3d_state_dict_from_jax,
    tan_state_dict_from_jax,
)
from tests.test_torch_grounding_train import TRUNK as GND_TRUNK
from tests.test_torch_grounding_train import _batch as gnd_batch
from tests.test_torch_small import jax_params


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"proj": {"kernel": rng.randn(12, 8).astype(np.float32)},
            "ln_final": {"scale": (1.0 + 0.1 * rng.randn(8)).astype(np.float32),
                         "bias": (0.1 * rng.randn(8)).astype(np.float32)}}


def _jax_encode(p, frames):
    pooled = frames.mean(axis=(1, 2))  # (B, 3)
    h = jnp.concatenate([pooled] * 4, -1) @ p["proj"]["kernel"].astype(frames.dtype)
    mu = h.mean(-1, keepdims=True)
    var = ((h - mu) ** 2).mean(-1, keepdims=True)
    ln = p["ln_final"]
    return ((h - mu) / jnp.sqrt(var + 1e-5) * ln["scale"] + ln["bias"]).astype(jnp.float32)


class _Encoder(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.proj = nn.Linear(12, 8, bias=False)
        self.ln_final = nn.LayerNorm(8)
        with torch.no_grad():
            self.proj.weight.copy_(torch.from_numpy(p["proj"]["kernel"].T))
            self.ln_final.weight.copy_(torch.from_numpy(p["ln_final"]["scale"]))
            self.ln_final.bias.copy_(torch.from_numpy(p["ln_final"]["bias"]))

    def forward(self, frames):
        pooled = frames.mean(dim=(1, 2))
        return self.ln_final(self.proj(torch.cat([pooled] * 4, -1)))


@pytest.mark.parametrize("fps,rows", [(1, 37), (8, 4)])
@pytest.mark.parametrize("half", [True, False])
def test_features_match_the_jax_harness(fps, rows, half):
    p = _weights()
    frames = np.random.RandomState(1).rand(37, 8, 8, 3).astype(np.float32)
    enc = _Encoder(p)
    got = extract_video_features(enc, frames, ExtractConfig(fps=fps, frame_bucket=16,
                                                            half=half), device="cpu")
    want = jax_extract(_jax_encode, p, frames,
                       JaxExtractConfig(fps=fps, frame_bucket=16, half=half))
    assert got.shape == want.shape == (rows, 8) and got.dtype == want.dtype == np.float16
    # float32: one float16 step at the largest value (a rounding may land
    # either side of it)
    tol = (1e-2 if half else 2.0 ** -10) * np.abs(want.astype(np.float32)).max()
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=0,
                               atol=tol)
    # the caller's module is left as it was
    assert all(t.dtype == torch.float32 for t in enc.parameters())


def _kept(cast: dict) -> set:
    return {k for k, v in cast.items() if v.dtype == torch.float32}


def _jax_kept(tree, bridge) -> tuple:
    """The port names of the tensors the JAX cast keeps float32: each leaf of
    ``tree`` marked 1 where the JAX cast keeps it, 0 where it casts, through
    the port's converter ``bridge``; with every name the converter gives."""
    marks = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(a.dtype == jnp.float32), np.float32), jax_cast(tree))
    out = bridge(marks)
    return {k for k, v in out.items() if bool(v.all())}, set(out)


def test_float32_set_equals_the_jax_cast_on_the_aligner():
    jm = JaxAligner(num_encoder_layers=2, num_joint_layers=2, width=32, heads=4, max_pos=64,
                    use_alignability_head=1)
    jp = jax_params(jm, jnp.zeros((1, 8, 24)), jnp.zeros((1, 2, 16)), jnp.zeros((1, 8), bool),
                    jnp.zeros((1, 2), bool))
    tm = TemporalAligner(num_encoder_layers=2, num_joint_layers=2, width=32, heads=4,
                         max_pos=64, use_alignability_head=1, video_dim=24, text_dim=16,
                         device="cpu")
    load_tan_params(tm, {"params": jp})
    want, names = _jax_kept(jp, lambda t: tan_state_dict_from_jax({"params": t}))
    got = _kept(bf16_params_keep_layernorm(tm))
    assert got & names == want
    assert "ln_video_init.bias" in want and "video_pre_proj.weight" not in want


def test_float32_set_equals_the_jax_cast_on_s3d():
    ref = s3d_reference_state(num_classes=32, seed=0)
    want, names = _jax_kept(jax_convert_s3d(ref), lambda t: {
        k: v for tree in s3d_state_dict_from_jax(t).values() for k, v in tree.items()})
    conv = convert_s3d_state_dict(ref)
    tensors = {**conv["params"], **conv["batch_stats"]}
    assert set(tensors) == names
    got = _kept(bf16_params_keep_layernorm(S3D(num_classes=32, device="cpu"), tensors))
    assert got == want
    assert {"conv1.bn1.weight", "mixed_5c.conv_b1_b.bn2.weight"} <= want
    assert not {"conv1.bn1.bias", "conv1.bn1.running_mean", "fc.weight"} & want


def _jax_paths(tree) -> tuple:
    """(``tree`` with leaf i filled with i + 1, the leaves' '/'-joined
    paths in that order)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in leaves]
    marks = [np.full(np.shape(a), i + 1, np.float32) for i, (_, a) in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, marks), paths


def _converted(kind):
    """(port module, the JAX tree of ``kind`` marked by leaf, its paths,
    the port's converter of such a tree to named tensors)."""
    if kind == "s3d":
        tree = jax_convert_s3d(s3d_reference_state(num_classes=32, seed=0))
        return S3D(num_classes=32, device="cpu"), *_jax_paths(tree["params"]), lambda t: (
            s3d_state_dict_from_jax({"params": t})["params"])
    if kind == "aligner":
        jm = JaxAligner(num_encoder_layers=2, num_joint_layers=2, width=32, heads=4,
                        max_pos=64, use_alignability_head=1)
        tree = jax_params(jm, jnp.zeros((1, 8, 24)), jnp.zeros((1, 2, 16)),
                          jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool))
        tm = TemporalAligner(num_encoder_layers=2, num_joint_layers=2, width=32, heads=4,
                             max_pos=64, use_alignability_head=1, video_dim=24, text_dim=16,
                             device="cpu")
        return tm, *_jax_paths(tree), lambda t: tan_state_dict_from_jax({"params": t})
    vi = kind.split("_")[1]
    jm = JaxGrounding(vi_encoder_type=vi, **GND_TRUNK, attn_impl="xla")
    b = gnd_batch(0, "grounding")
    tree = jax_params(jm, b["video_features"], b["narration_features"],
                      b["video_padding_mask"], b["narration_padding_mask"])
    tm = GroundingModel(vi_encoder_type=vi, **GND_TRUNK, device="cpu")
    return tm, *_jax_paths(tree), lambda t: grounding_state_dict_from_jax({"params": t})


@pytest.mark.parametrize("kind", ["aligner", "grounding_mlp", "grounding_transformer", "s3d"])
def test_jax_name_inverts_the_converter(kind):
    """``jax_name`` of every tensor a converter gives is the path of the
    JAX leaf it was converted from, so the cast reads the names the
    converters use."""
    module, marked, paths, bridge = _converted(kind)
    out = bridge(marked)
    assert len(out) == len(paths)
    for name, t in out.items():
        assert jax_name(name, module) == paths[int(t.flatten()[0]) - 1], name


def test_decode_is_gated_and_a_corpus_run_restarts(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    video = tmp_path / "a.mp4"
    video.write_bytes(b"not a video")
    assert decode_frames(str(video)) is None and probe_duration(str(video)) is None
    assert decode_frames(str(tmp_path / "missing.mp4")) is None

    frames = {"a": np.random.RandomState(2).rand(5, 8, 8, 3).astype(np.float32), "b": None}
    out = tmp_path / "feats"
    cfg = ExtractConfig(frame_bucket=4, half=False)
    enc = _Encoder(_weights(3))
    paths = [str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")]

    def load(path):
        return frames[os.path.splitext(os.path.basename(path))[0]]

    written = extract_corpus(enc, paths, str(out), cfg, frame_loader=load, device="cpu")
    assert written == [str(out / "a.npy")]
    feats = np.load(out / "a.npy")
    np.testing.assert_array_equal(
        feats, extract_video_features(enc, frames["a"], cfg, device="cpu"))
    assert extract_corpus(enc, paths, str(out), cfg, frame_loader=load, device="cpu") == []
    empty = extract_video_features(enc, np.zeros((0, 8, 8, 3), np.float32), cfg, device="cpu")
    assert empty.shape == (0, 1) and empty.dtype == np.float16


def test_the_run_is_on_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the run would take it")
    frames = np.zeros((2, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_video_features(_Encoder(_weights()), frames)
    assert extract_video_features(_Encoder(_weights()), frames, device="cpu").shape == (2, 8)
