"""The port's TemporalAligner against the JAX model on the same weights.

The JAX model runs with attn_impl="fused", mlp_impl="fused" (its Pallas
kernels in interpret mode); the port's kernel wrappers take their plain
versions on the CPU. Weights are drawn from a numpy seed in the JAX layout
and reach the port through its weight bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.utils.convert import load_tan_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

SMALL = dict(num_encoder_layers=2, num_joint_layers=2, width=128, heads=4,
             input_dim=48, max_pos=256, use_alignability_head=1)


def _numpy_params(model, seed):
    """A param tree of ``model``'s structure drawn from a numpy seed
    (LayerNorm scales near 1); eval_shape traces the init without running it."""
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 48)), jnp.zeros((1, 2, 48)),
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
    """JAX and port aligners on the same numpy-seeded weights."""
    jm = JaxAligner(**SMALL, attn_impl="fused", mlp_impl="fused")
    params = _numpy_params(jm, 0)
    tm = TemporalAligner(**SMALL, device="cpu").eval()
    load_tan_params(tm, params)
    return jm, params, tm


def _inputs(seed, b=2, t=24, n=5, dim=48):
    rng = np.random.RandomState(seed)
    video = rng.randn(b, t, dim).astype(np.float32)
    lang = rng.randn(b, n, dim).astype(np.float32)
    vmask = np.zeros((b, t), bool)
    vmask[-1, -7:] = True
    lmask = np.zeros((b, n), bool)
    lmask[0, -2:] = True
    return video, lang, vmask, lmask


def test_forward_matches_jax(small_pair):
    jm, params, tm = small_pair
    arrays = _inputs(1)
    want = jm.apply(params, *(jnp.asarray(a) for a in arrays), deterministic=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in arrays))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-5, rtol=1e-4, err_msg=k)
    with torch.no_grad():
        feats = tm(*(torch.from_numpy(a) for a in arrays), return_sim_volumes=False)
    assert "logits_dual" not in feats and "joint_feature_text" in feats


@pytest.mark.parametrize("interp", [None, 64, (64, 32)])
def test_text_visual_sim_matches_jax(small_pair, interp):
    jm, params, tm = small_pair
    video, lang, vmask, lmask = _inputs(2)
    kw = {} if interp is None else dict(interpolate_from=interp)
    want = jm.apply(params, jnp.asarray(video), jnp.asarray(lang),
                    video_padding_mask=jnp.asarray(vmask),
                    lang_padding_mask=jnp.asarray(lmask),
                    method=JaxAligner.text_visual_sim, **kw)
    with torch.no_grad():
        got = tm.text_visual_sim(torch.from_numpy(video), torch.from_numpy(lang),
                                 video_padding_mask=torch.from_numpy(vmask),
                                 lang_padding_mask=torch.from_numpy(lmask), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-5, rtol=1e-4, err_msg=k)


def test_text_visual_sim_padded_length_interpolation(small_pair):
    """pos_interp_len: a padded global-mode bucket resamples the pos table to
    the real video length, as the JAX model does."""
    _, params, tm = small_pair
    video, lang, _, _ = _inputs(3, b=1, t=40, n=3)
    vmask = np.zeros((1, 40), bool)
    vmask[0, 30:] = True
    want = JaxAligner(**SMALL, attn_impl="xla").apply(params, jnp.asarray(video), jnp.asarray(lang),
                    interpolate_from=64, video_padding_mask=jnp.asarray(vmask),
                    pos_interp_len=jnp.float32(30), method=JaxAligner.text_visual_sim)
    with torch.no_grad():
        got = tm.text_visual_sim(torch.from_numpy(video), torch.from_numpy(lang),
                                 interpolate_from=64,
                                 video_padding_mask=torch.from_numpy(vmask),
                                 pos_interp_len=30)
    for k in ("sim", "dual-sim"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-5, rtol=1e-4, err_msg=k)


def test_random_pos_start_uses_the_generator(small_pair):
    _, _, tm = small_pair
    arrays = [torch.from_numpy(a) for a in _inputs(4)]
    with torch.no_grad():
        a = tm(*arrays, deterministic=False, generator=torch.Generator().manual_seed(5))
        b = tm(*arrays, deterministic=False, generator=torch.Generator().manual_seed(5))
        c = tm(*arrays, deterministic=True)
    np.testing.assert_array_equal(a["logits_dual"].numpy(), b["logits_dual"].numpy())
    assert not np.allclose(a["logits_dual"].numpy(), c["logits_dual"].numpy())


def test_sine_pos_enc_model_loads_jax_params():
    """A sine pos table is a buffer the model computes; the bridge fills the
    rest, and the forward matches the JAX model."""
    cfg = dict(SMALL, pos_enc="sine", use_alignability_head=0)
    jm = JaxAligner(**cfg, attn_impl="xla")
    params = _numpy_params(jm, 1)
    tm = TemporalAligner(**cfg, device="cpu")
    load_tan_params(tm, params)
    arrays = _inputs(5)
    want = jm.apply(params, *(jnp.asarray(a) for a in arrays))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(got["logits_joint"].numpy(),
                               np.asarray(want["logits_joint"]), atol=5e-5, rtol=1e-4)
