"""The port's MIL-NCE grid and TAN loss against the JAX package.

Inputs are drawn from numpy seeds and handed to both. The JAX grid kernel
(ops/milnce_grid.py) runs as its own CPU tests run it, in interpret mode;
the port's ``grid_lse2`` takes its plain composition on CPU tensors.
Tolerances: the grid and the masks at 1e-5 relative; the golden
``tan_loss.npz`` as tests/test_golden.py (2e-4 relative, confidence-ratio
1e-5); feature mode against the JAX scan backend as tests/test_losses.py
(scalars 2e-5, feature grads 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.losses import milnce as jmilnce
from exoground_tpu.ops import masks as jmasks
from exoground_tpu.ops import milnce_grid as jgrid
from exoground_tpu_torch.losses import milnce
from exoground_tpu_torch.losses.milnce import TANLossConfig, tan_loss
from exoground_tpu_torch.ops import masks
from exoground_tpu_torch.ops.milnce_grid import (
    NEG_FILL,
    grid_lse2,
    grid_lse2_plain,
    kernel_eligible,
)
from tests import golden_common as G
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rtol * scale, (err_msg, np.abs(got - want).max(), scale)


# ------------------------------------------------------------------ masks
def test_masks_match_jax():
    rng = np.random.RandomState(0)
    b, n, t = 3, 5, 16
    start = rng.randint(0, t - 3, (b, n)).astype(np.float32)
    end = start + rng.randint(1, 6, (b, n))
    start[0, -1], end[0, -1] = masks.PAD_START, masks.PAD_END
    np.testing.assert_array_equal(
        masks.mask_from_time(_t(start), _t(end), t).numpy(),
        np.asarray(jmasks.mask_from_time(jnp.asarray(start), jnp.asarray(end), t)))
    dur = rng.randint(0, 7, (b, n)).astype(np.float32)
    np.testing.assert_allclose(
        masks.window_scan_kernel(_t(dur), t).numpy(),
        np.asarray(jmasks.window_scan_kernel(jnp.asarray(dur), t)), rtol=1e-6, atol=0)
    x = rng.randn(b, n).astype(np.float32)
    valid = rng.rand(b, n) > 0.3
    for q in (0.0, 0.3, 0.5, 0.7, 1.0):
        np.testing.assert_allclose(
            float(masks.masked_quantile(_t(x), _t(valid), q)),
            float(jmasks.masked_quantile(jnp.asarray(x), jnp.asarray(valid), q)),
            rtol=1e-6, err_msg=f"q={q}")
    np.testing.assert_allclose(
        float(masks.masked_mean(_t(x), _t(valid.astype(np.float32)))),
        float(jmasks.masked_mean(jnp.asarray(x), jnp.asarray(valid.astype(np.float32)))),
        rtol=1e-6)
    # quantile semantics: torch.quantile over the valid subset
    np.testing.assert_allclose(float(masks.masked_quantile(_t(x), _t(valid), 0.3)),
                               float(torch.quantile(_t(x)[_t(valid)], 0.3)), rtol=1e-6)


# ------------------------------------------------------------------- grid
def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("st", [1, 2])
def test_grid_lse2_plain_matches_jax_kernel(st):
    """Values and vjp grads at a ragged shape with invalid columns: R = 36
    and Cc = 15 are no multiple of the TPU kernel's blocks, so the JAX side
    pads rows and columns and masks them."""
    s, r, cc, c = 2, 36, 15, 128
    rng = np.random.RandomState(10 + st)
    v, t = _unit(rng, s, r, c), _unit(rng, st, cc, c)
    valid = np.ones(cc, bool)
    valid[[2, 7, 14]] = False
    gv, gt = rng.randn(s, r).astype(np.float32), rng.randn(s, cc).astype(np.float32)
    inv = 1.0 / 0.07

    (jv, jt), vjp = jax.vjp(
        lambda a, b: jgrid.grid_lse2(a, b, jnp.asarray(valid), inv),
        jnp.asarray(v), jnp.asarray(t))
    jdv, jdt = vjp((jnp.asarray(gv), jnp.asarray(gt)))

    a, b = _t(v).requires_grad_(), _t(t).requires_grad_()
    pv, pt = grid_lse2_plain(a, b, _t(valid), inv)
    torch.autograd.backward([pv, pt], [_t(gv), _t(gt)])
    _close(pv.detach(), jv, 1e-5, "v_den")
    _close(pt.detach()[:, valid], np.asarray(jt)[:, valid], 1e-5, "t_den valid")
    _close(pt.detach()[:, ~valid], np.asarray(jt)[:, ~valid], 1e-5, "t_den invalid")
    np.testing.assert_allclose(pt.detach()[:, ~valid].numpy(), NEG_FILL + np.log(r), rtol=1e-6)
    _close(a.grad, jdv, 1e-5, "dv")
    _close(b.grad, jdt, 1e-5, "dt")


def test_grid_dispatch_on_the_cpu():
    """CPU tensors take the plain composition under every impl; the test
    is the JAX one without its TPU-only parts."""
    rng = np.random.RandomState(3)
    v, t = _t(_unit(rng, 2, 16, 128)), _t(_unit(rng, 1, 6, 128))
    valid = torch.ones(6, dtype=torch.bool)
    want = grid_lse2_plain(v, t, valid, 2.0)
    for impl in ("auto", "plain", "kernel"):
        got = grid_lse2(v, t, valid, 2.0, impl=impl)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError):
        grid_lse2(v, t, valid, 2.0, impl="scan")
    with pytest.raises(ValueError):
        milnce.set_grid_impl("scan")
    assert kernel_eligible(8, 128) and kernel_eligible(4096, 512)
    assert not kernel_eligible(7, 128) and not kernel_eligible(64, 96)
    assert kernel_eligible(512, 512)  # no column cap: Cc never enters the test


# ------------------------------------------------------------ golden loss
@pytest.mark.parametrize("model,agreement,threshold,align_head,agree_type",
                         G.TAN_LOSS_CONFIGS)
def test_golden_tan_loss_volume_mode(model, agreement, threshold, align_head, agree_type):
    z = np.load(os.path.join(G.GOLDEN_DIR, "tan_loss.npz"))
    (ld, lj, ed, ej, starts, ends, text_pad, video_pad, a_dual, a_joint,
     abs_pos) = G.tan_loss_inputs(seed=G.TAN_LOSS_SEEDS[agree_type])
    b, _, t, _, n = ld.shape
    start = np.full((b, n), t + 100.0, np.float32)
    end = np.full((b, n), -100.0, np.float32)
    for i in range(b):
        start[i, :len(starts[i])] = starts[i]
        end[i, :len(ends[i])] = ends[i]
    cfg = TANLossConfig(model=model, learn_agreement=bool(agreement),
                        temporal_agreement_type=agree_type, loss_threshold=threshold,
                        use_alignability_head=bool(align_head))
    logits = {"logits_dual": _t(ld), "logits_joint": _t(lj),
              "dual_logits_alignability": _t(a_dual),
              "joint_logits_alignability": _t(np.repeat(a_joint, 3, axis=1)[:, :3])}
    if model == "cotrain":
        logits["ema-logits_dual"] = _t(ed)
        logits["ema-logits_joint"] = _t(ej)
    ours = tan_loss(_t(start), _t(end), logits, _t(video_pad), _t(text_pad), cfg,
                    abs_text_pos=_t(abs_pos))
    tag = f"{model}_{agreement}_{threshold}_{align_head}_{agree_type}"
    keys = ["loss", "loss-dual", "loss-joint"] + (["loss-joint-bce"] if align_head else [])
    for key in keys:
        r = float(z[f"{tag}::{key}"])
        assert abs(float(ours[key]) - r) / (abs(r) + 1e-6) < 2e-4, (key, float(ours[key]), r)
    if agreement:
        assert abs(float(ours["confidence-ratio"])
                   - float(z[f"{tag}::confidence-ratio"])) < 1e-5


# ------------------------------------------------- feature mode vs JAX scan
def _world(seed, b=3, s=2, t=12, n=4, c=16, bc=None):
    rng = np.random.RandomState(seed)
    bc = bc or b
    feats = {
        "dual_feature_video": _unit(rng, b, s, t, c),
        "dual_feature_text": _unit(rng, bc, n, c),
        "joint_feature_video": _unit(rng, b, s, t, c),
        "joint_feature_text": _unit(rng, bc, s, n, c),
    }
    ema = {f"ema-{k}": (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
           for k, v in feats.items() if v.shape[0] == b}
    align = {"joint_logits_alignability": rng.randn(b, s, n, 1).astype(np.float32),
             "dual_logits_alignability": rng.randn(b, n, 1).astype(np.float32)}
    starts = rng.randint(0, t - 4, (b, n)).astype(np.float32)
    ends = starts + rng.randint(2, 5, (b, n))
    text_pad = np.zeros((b, n), bool)
    text_pad[0, -1] = True
    starts[text_pad], ends[text_pad] = masks.PAD_START, masks.PAD_END
    video_pad = np.zeros((b, t), bool)
    video_pad[1, -2:] = True
    abs_pos = np.stack([starts / t, ends / t], axis=-1).astype(np.float32)
    return feats, ema, align, starts, ends, video_pad, text_pad, abs_pos


FEATURE_CASES = {
    "base": (TANLossConfig(), False),
    "cotrain_keep_threshold_head": (TANLossConfig(
        model="cotrain", learn_agreement=True, temporal_agreement_type="keep",
        loss_threshold=0.7, use_alignability_head=True), False),
    "gathered_offset_threshold": (TANLossConfig(loss_threshold=0.4), True),
}


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_feature_mode_matches_jax_scan_backend(case):
    cfg, gathered = FEATURE_CASES[case]
    b, n = 3, 4
    bc = 2 * b if gathered else b
    feats, ema, align, s, e, vp, tp, abs_pos = _world(21, b=b, n=n, bc=bc)
    kw = {}
    if gathered:
        col_pad = np.zeros((bc, n), bool)
        col_pad[0, -1] = True
        col_pad[4, -2:] = True
        kw = dict(col_text_padding_mask=col_pad, col_offset=b)
    fixed = {**ema, **align}
    diff = list(feats)

    def run_jax():
        jmilnce.set_grid_impl("scan")
        try:
            jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in kw.items()}

            def f(fd):
                lg = {**fd, **{k: jnp.asarray(v) for k, v in fixed.items()}}
                return jmilnce.tan_loss(jnp.asarray(s), jnp.asarray(e), lg, jnp.asarray(vp),
                                        jnp.asarray(tp), _jcfg(cfg),
                                        abs_text_pos=jnp.asarray(abs_pos), **jkw)

            fd = {k: jnp.asarray(feats[k]) for k in diff}
            return f(fd), jax.grad(lambda d: f(d)["loss"])(fd)
        finally:
            jmilnce.set_grid_impl("auto")

    want, want_g = run_jax()
    leaves = {k: _t(feats[k]).requires_grad_() for k in diff}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = tan_loss(_t(s), _t(e), {**leaves, **{k: _t(v) for k, v in fixed.items()}},
                   _t(vp), _t(tp), cfg, abs_text_pos=_t(abs_pos), **tkw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=2e-5, atol=1e-6,
                                   err_msg=f"key {k}")
    grads = torch.autograd.grad(got["loss"], [leaves[k] for k in diff])
    for k, g in zip(diff, grads):
        a = np.asarray(want_g[k])
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(a).max()), err_msg=f"grad {k}")


def _jcfg(cfg):
    return jmilnce.TANLossConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_feature_mode_matches_volume_mode():
    """The two grid modes of the port agree (the volumes built from the
    same features), as the JAX package's two modes do."""
    feats, ema, align, s, e, vp, tp, abs_pos = _world(5)
    cfg = TANLossConfig(model="cotrain", learn_agreement=True, loss_threshold=0.5,
                        use_alignability_head=True)
    fd = {k: _t(v) for k, v in {**feats, **ema, **align}.items()}
    vols = {
        "logits_dual": torch.einsum("astc,bkc->astbk", fd["dual_feature_video"],
                                    fd["dual_feature_text"]),
        "logits_joint": torch.einsum("astc,bskc->astbk", fd["joint_feature_video"],
                                     fd["joint_feature_text"]),
        "ema-logits_dual": torch.einsum("astc,bkc->astbk", fd["ema-dual_feature_video"],
                                        fd["ema-dual_feature_text"]),
        "ema-logits_joint": torch.einsum("astc,bskc->astbk", fd["ema-joint_feature_video"],
                                         fd["ema-joint_feature_text"]),
        **{k: fd[k] for k in align},
    }
    args = (_t(s), _t(e))
    out_f = tan_loss(*args, fd, _t(vp), _t(tp), cfg, abs_text_pos=_t(abs_pos))
    out_v = tan_loss(*args, vols, _t(vp), _t(tp), cfg, abs_text_pos=_t(abs_pos))
    assert set(out_f) == set(out_v)
    for k in out_v:
        np.testing.assert_allclose(float(out_f[k]), float(out_v[k]), rtol=3e-5, atol=1e-6,
                                   err_msg=k)
