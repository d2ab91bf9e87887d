"""The port's HTM-Align evaluator and alignment service against the JAX ones.

Both sides run the same numpy-seeded items and weights (the port's through
its weight bridge); the JAX model runs its Pallas kernels in interpret mode
(attn_impl="fused", mlp_impl="fused"). Tolerances: Recall within 1e-9, AUC
within 1e-6, predict() argmax equal and scores within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.evals import AlignEvalConfig as JaxConfig
from exoground_tpu.evals import FusedAlignEvaluator as JaxEvaluator
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.serve import AlignmentService as JaxService
from exoground_tpu.serve import AlignRequest as JaxRequest
from exoground_tpu_torch.evals import align as talign
from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
from exoground_tpu_torch.evals.bench_items import make_item
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.serve import AlignmentService, AlignRequest
from exoground_tpu_torch.utils.convert import load_tan_params
from tests import golden_common as G

DIM = 32
ARCH = dict(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4,
            input_dim=DIM, max_pos=128)
CFG = dict(seq_len=32, global_len_bucket=32, text_bucket=8)


@pytest.fixture(scope="module")
def models():
    jm = JaxAligner(**ARCH, attn_impl="fused", mlp_impl="fused")
    shapes = jax.eval_shape(
        JaxAligner(**ARCH, attn_impl="xla").init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8, DIM)), jnp.zeros((1, 2, DIM)),
        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool))
    rng = np.random.RandomState(0)

    def draw(path, sd):
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 else sd.shape[0] ** -0.5)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tm = TemporalAligner(**ARCH, device="cpu")
    load_tan_params(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def items():
    out = [make_item(s, v, DIM, DIM) for s, v in enumerate([70, 90, 60, 100])]
    out[2]["aligned"][:] = 1  # no non-alignable text: a zero-window video
    return out


def _close_metrics(got, want):
    np.testing.assert_allclose(got["Recall"], want["Recall"], atol=1e-9)
    np.testing.assert_allclose(got["AUC"], want["AUC"], atol=1e-6)


@pytest.mark.parametrize("all_texts", [False, True])
def test_evaluator_matches_jax(models, items, all_texts):
    jm, params, tm = models
    want = JaxEvaluator(jm, params, JaxConfig(**CFG, group_videos=3))(
        items, all_texts_active=all_texts)
    ev = FusedAlignEvaluator(tm, AlignEvalConfig(**CFG, group_videos=3), device="cpu")
    _close_metrics(ev(items, all_texts_active=all_texts), want)


def test_predict_matches_jax(models, items):
    jm, params, tm = models
    cfg = dict(CFG, transfer_dtype="float16")
    want = JaxEvaluator(jm, params, JaxConfig(**cfg)).predict(items)
    got = FusedAlignEvaluator(tm, AlignEvalConfig(**cfg), device="cpu").predict(items)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["argmax"], w["argmax"])
        for k in ("score", "align_score"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=1e-5, err_msg=k)


def test_evaluator_equals_host_protocol(models, items):
    """The host stitcher is the device evaluator's oracle."""
    _, _, tm = models
    cfg = AlignEvalConfig(**CFG)
    host = talign.test_alignment_htm(items, talign.make_tan_sim_fn(tm), cfg)
    _close_metrics(FusedAlignEvaluator(tm, cfg, device="cpu")(items), host)


def test_evaluator_grouping_invariance(models, items):
    """Packing 1, 3 or all videos per group must not change the metrics."""
    _, _, tm = models
    res = [FusedAlignEvaluator(tm, AlignEvalConfig(**CFG, group_videos=g),
                               device="cpu")(items) for g in (1, 3, 8)]
    for r in res[1:]:
        _close_metrics(r, res[0])


def test_update_params_swaps_weights(models, items):
    _, _, tm = models
    cfg = AlignEvalConfig(**CFG)
    ev = FusedAlignEvaluator(tm, cfg, device="cpu")
    other = TemporalAligner(**ARCH, device="cpu")
    ev.update_params(other.state_dict())
    _close_metrics(ev(items), FusedAlignEvaluator(other, cfg, device="cpu")(items))


def test_host_protocol_matches_golden():
    """evals/align.py against the frozen reference metrics
    (tests/test_golden.py::test_golden_align_protocol, same worlds)."""
    z = np.load(os.path.join(G.GOLDEN_DIR, "align_protocol.npz"))
    for use_head in (False, True):
        tag = "head" if use_head else "nohead"
        its, _ = G.align_protocol_items()
        got = talign.test_alignment_htm(its, G.align_our_sim_fn(use_head), AlignEvalConfig(
            sim_scale=1.0, use_alignability_head=use_head, window_chunk=5, text_bucket=4))
        np.testing.assert_allclose(got["Recall"], z[f"out::overlap_{tag}_recall"], atol=1e-9)
        np.testing.assert_allclose(got["AUC"], z[f"out::overlap_{tag}_auc"], atol=1e-7)
        g_items, _ = G.align_protocol_items(seed=1)
        gg = talign.test_alignment_htm(g_items, G.align_our_sim_fn(use_head), AlignEvalConfig(
            sim_scale=1.0, use_alignability_head=use_head, method="global",
            global_len_bucket=32))
        np.testing.assert_allclose(gg["Recall"], z[f"out::global_{tag}_recall"], atol=1e-9)
        np.testing.assert_allclose(gg["AUC"], z[f"out::global_{tag}_auc"], atol=1e-7)


def test_roc_auc_matches_jax_package():
    from exoground_tpu.evals.align import roc_auc

    rng = np.random.RandomState(3)
    labels = rng.rand(50) > 0.5
    scores = np.round(rng.randn(50), 1)  # ties
    assert talign.roc_auc(labels, scores) == roc_auc(labels, scores)


@pytest.mark.parametrize("with_ts", [False, True])
def test_alignment_service_matches_jax(models, items, with_ts):
    jm, params, tm = models
    it = items[1]
    kw = dict(start=it["start"][::-1].copy(), end=it["end"][::-1].copy()) if with_ts else {}
    te = it["text_embed"][::-1].copy() if with_ts else it["text_embed"]
    want = JaxService(jm, params, seq_len=32).align(
        JaxRequest(video=it["video"], text_embeds=te, **kw))
    svc = AlignmentService(tm, seq_len=32, device="cpu")
    got = svc.align(AlignRequest(video=it["video"], text_embeds=te, **kw))
    assert got["best_second"] == want["best_second"]
    for k in ("score", "align_score"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="BOTH"):
        svc.align(AlignRequest(video=it["video"], text_embeds=te, start=it["start"]))


@pytest.mark.parametrize("field,value", [("preproject", True), ("eval_devices", 2)])
def test_later_slice_config_values_raise(models, items, field, value):
    """eval_devices > 1 waits for the multi-device slice. preproject=True
    arrived with resident serving: the config builds, and the streaming
    paths refuse it with ValueError (there is no preload to amortize the
    input stages into)."""
    if field == "eval_devices":
        with pytest.raises(NotImplementedError, match="slice"):
            AlignEvalConfig(**{field: value})
        return
    ev = FusedAlignEvaluator(models[2], AlignEvalConfig(**CFG, preproject=True), device="cpu")
    with pytest.raises(ValueError, match="resident-serving"):
        ev(items)
    with pytest.raises(ValueError, match="resident-serving"):
        ev.predict(items)


def test_bfloat16_compute_runs_on_cpu(models, items):
    """compute_dtype casts the evaluator's copy once; the caller's model
    keeps its float32 weights."""
    _, _, tm = models
    ev = FusedAlignEvaluator(tm, AlignEvalConfig(**CFG, compute_dtype="bfloat16"),
                             device="cpu")
    m = ev(items)
    assert 0.0 <= m["Recall"] <= 1.0 and 0.0 <= m["AUC"] <= 1.0
    assert next(tm.parameters()).dtype == torch.float32
    assert next(ev._model.parameters()).dtype == torch.bfloat16
