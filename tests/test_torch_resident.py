"""Resident serving in the port against itself and against the JAX package.

``FusedAlignEvaluator.preload`` / ``run_preloaded`` / ``run_many`` /
``preload_queries`` / ``run_queries`` / ``predict_queries`` (with and
without ``cfg.preproject``) and ``AlignmentService.score_checkpoints`` /
``align_batch_requests``, each case a mirror of its JAX test
(tests/test_evals.py, tests/test_serve.py). Both sides run the same
numpy-seeded items and weights (the port's through ``load_tan_params``);
the JAX model runs its Pallas kernels in interpret mode (attn_impl="fused",
mlp_impl="fused"). Tolerances: Recall within 1e-9, AUC within 1e-6,
predictions' argmax equal and scores within 1e-5; the port against itself
(resident against streaming, run_many against one checkpoint at a time)
is exact. Under int8 the JAX body runs jitted and multiplies by 1/127, so
the port meets it within 1e-3 (as in tests/test_torch_quant.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.evals import AlignEvalConfig as JaxConfig
from exoground_tpu.evals import FusedAlignEvaluator as JaxEvaluator
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.serve import AlignmentService as JaxService
from exoground_tpu_torch.evals import NEG_FILL, AlignEvalConfig, FusedAlignEvaluator
from exoground_tpu_torch.evals import align_fused as tfused
from exoground_tpu_torch.evals.bench_items import make_item, make_query_batch
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.serve import AlignmentService, AlignRequest
from exoground_tpu_torch.utils.convert import load_tan_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

DIM = 32
ARCH = dict(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4,
            input_dim=DIM, max_pos=128)
CFG = dict(seq_len=32, global_len_bucket=32, text_bucket=8)
TRANSFERS = ("float32", "float16", "int8", "int4")


def _params(seed, head=0):
    """Seeded JAX params for ARCH (head: the alignability head)."""
    shapes = jax.eval_shape(
        JaxAligner(**ARCH, attn_impl="xla", use_alignability_head=head).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 8, DIM)), jnp.zeros((1, 2, DIM)),
        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool))
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 else sd.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(params, head=0):
    tm = TemporalAligner(**ARCH, use_alignability_head=head, device="cpu")
    load_tan_params(tm, params)
    return tm


def _jax_model(head=0):
    return JaxAligner(**ARCH, attn_impl="fused", mlp_impl="fused", use_alignability_head=head)


@pytest.fixture(scope="module")
def ckpts():
    """k = 3 distinct checkpoints: JAX params and the port's state dicts."""
    ps = [_params(s) for s in range(3)]
    return ps, [_port(p).state_dict() for p in ps]


@pytest.fixture(scope="module")
def items():
    out = [make_item(s, v, DIM, DIM) for s, v in enumerate([70, 90, 60, 100])]
    out[2]["aligned"][:] = 1  # no non-alignable text: a zero-window video
    return out


def _batch(seed, videos, zero_window_video=None):
    """Same videos, fresh texts (4-8 a video, so the batches' text tables
    differ); ``zero_window_video``'s texts are all aligned: no window."""
    r = np.random.RandomState(seed)
    out = []
    for vi, video in enumerate(videos):
        vlen, n = video.shape[0], int(r.randint(4, 9))
        if vi == zero_window_video:
            aligned = np.ones(n, np.int64)
        else:
            aligned = (r.rand(n) > 0.4).astype(np.int64)
            aligned[0], aligned[-1] = 1, 0
        centers = np.sort(r.rand(n)) * max(vlen - 6, 1) + 2
        out.append({"video": video, "start": np.maximum(centers - 2, 0),
                    "end": np.minimum(centers + 2, vlen), "aligned": aligned,
                    "text_embed": r.randn(n, DIM).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def batches():
    """Three query batches over five videos (a 6-frame one takes the
    one-window fallback); in batch 1 video 1 activates no window."""
    rng = np.random.RandomState(7)
    videos = [rng.randn(v, DIM).astype(np.float32) for v in (60, 6, 72, 48, 90)]
    return [_batch(0, videos), _batch(1, videos, zero_window_video=1), _batch(2, videos)]


def _close(got, want, auc=1e-6):
    np.testing.assert_allclose(got["Recall"], want["Recall"], atol=1e-9)
    np.testing.assert_allclose(got["AUC"], want["AUC"], atol=auc)


def _close_preds(got, want, score_tol=1e-5):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g["argmax"], w["argmax"])
        for k in ("score", "align_score"):
            np.testing.assert_allclose(g[k], w[k], atol=score_tol, rtol=score_tol, err_msg=k)


# ------------------------------------------------------------------ preload
@pytest.mark.parametrize("transfer", TRANSFERS)
def test_preloaded_matches_streaming(ckpts, items, transfer):
    """Mirror of test_fused_eval_preloaded_matches_streaming: run_preloaded
    equals the streaming sweep exactly, also after update_params (one preload
    serves many checkpoints), and the JAX run_preloaded."""
    ps, sds = ckpts
    cfg = dict(CFG, group_videos=3, transfer_dtype=transfer)
    ev = FusedAlignEvaluator(_port(ps[0]), AlignEvalConfig(**cfg), device="cpu")
    pre = ev.preload(items)
    ref = ev(items)
    assert ev.run_preloaded(pre) == ref
    jev = JaxEvaluator(_jax_model(), ps[0], JaxConfig(**cfg))
    _close(ref, jev.run_preloaded(jev.preload(items)))
    ev.update_params(sds[1])
    ref2 = ev(items)
    assert ev.run_preloaded(pre) == ref2 != ref


def test_preloaded_block_model(ckpts, items):
    """The whole-block model (attn_impl="fused", mlp_impl="fused", the block
    kernels' path on the card) on the resident path: run_preloaded equals
    the streaming sweep and the JAX run_preloaded; run_many equals one
    checkpoint at a time."""
    ps, sds = ckpts
    tm = TemporalAligner(**ARCH, attn_impl="fused", mlp_impl="fused", device="cpu")
    load_tan_params(tm, ps[0])
    cfg = dict(CFG, group_videos=3)
    ev = FusedAlignEvaluator(tm, AlignEvalConfig(**cfg), device="cpu")
    pre = ev.preload(items)
    ref = ev(items)
    assert ev.run_preloaded(pre) == ref
    jev = JaxEvaluator(_jax_model(), ps[0], JaxConfig(**cfg))
    _close(ref, jev.run_preloaded(jev.preload(items)))
    many = ev.run_many(pre, sds[1:])
    for sd, got in zip(sds[1:], many, strict=True):
        ev.update_params(sd)
        assert ev.run_preloaded(pre) == got


def test_pipelined_sweeps_reduce_in_order(ckpts, items):
    """dispatch_preloaded twice before either reduce (the continuous-load
    shape): each reduces to the lone sweep's metrics."""
    ps, _ = ckpts
    ev = FusedAlignEvaluator(_port(ps[0]), AlignEvalConfig(**CFG, group_videos=3),
                             device="cpu")
    pre = ev.preload(items)
    first, second = ev.dispatch_preloaded(pre), ev.dispatch_preloaded(pre)
    want = ev.run_preloaded(pre)
    assert ev.reduce_preloaded(second, pre) == want == ev.reduce_preloaded(first, pre)


# ----------------------------------------------------------------- run_many
@pytest.mark.parametrize("matmul", ["default", "int8"])
def test_run_many_matches_sequential_and_jax(ckpts, items, matmul):
    """Mirror of test_run_many_matches_sequential_update_params: entry i of
    run_many equals update_params(sd_i) + run_preloaded exactly (under int8
    each checkpoint quantizes its own weights: the weight cache never serves
    one checkpoint's entry to another) and the JAX run_many on the same
    three weights; the split halves, a prebuilt stack, the guards, and one
    result (one D2H copy) a group for all k rows."""
    ps, sds = ckpts
    cfg = dict(CFG, group_videos=3, matmul_dtype=matmul)
    ev = FusedAlignEvaluator(_port(ps[0]), AlignEvalConfig(**cfg), device="cpu")
    pre = ev.preload(items)
    many = ev.run_many(pre, sds)
    assert len(many) == 3 and len({(m["Recall"], m["AUC"]) for m in many}) > 1
    jmany = JaxEvaluator(_jax_model(), ps[0], JaxConfig(**cfg)).run_many(
        JaxEvaluator(_jax_model(), ps[0], JaxConfig(**cfg)).preload(items), ps)
    for got, want in zip(many, jmany, strict=True):
        _close(got, want, auc=1e-6 if matmul == "default" else 1e-3)
    for sd, got in zip(sds, many):
        ev.update_params(sd)
        assert ev.run_preloaded(pre) == got
    stacked = ev.stack_checkpoints(sds)
    assert ev.run_many(pre, stacked) == many
    assert ev.run_many(pre, stacked) == many  # the stack and its cached weights reused
    pendings = ev.dispatch_many(pre, stacked)
    assert [ev.reduce_preloaded(p, pre) for p in pendings] == many
    if matmul == "int8":
        # the card's int8 wrappers read W_in and c_fc through the weight
        # cache: each stacked checkpoint keeps its own entry, hit again on
        # the next sweep, and holds its own weights' quantization
        for name in ("video_temporal_encoder.resblocks.0.attn.in_proj_weight",
                     "joint_temporal_encoder.resblocks.0.mlp.c_fc.weight"):
            ws = [sd[f"model.{name}"] for sd in stacked.state_dicts]
            qs = [quant.quantized_weight(w) for w in ws]
            for w, q, sd in zip(ws, qs, sds):
                assert quant.quantized_weight(w) is q
                want_q = quant._quant_first_axis(sd[name])
                assert all(torch.equal(a, b) for a, b in zip(q, want_q))
    rows = [rec[-1] for p in pendings for rec in p if rec[-1] is not None]
    n_groups = sum(e[0] == "group" for e in pre.entries)
    assert all(isinstance(r, tfused._StackRow) for r in rows)
    assert len({id(r._stack) for r in rows}) == n_groups
    assert ev.run_many(pre, []) == []
    with pytest.raises(ValueError):
        ev.stack_checkpoints([])
    bad = dict(sds[0])
    bad.pop("mlp.bias")
    with pytest.raises(ValueError):
        ev.run_many(pre, [sds[0], bad])
    wrong = dict(sds[0], **{"mlp.bias": torch.zeros(3)})
    with pytest.raises(ValueError):
        ev.stack_checkpoints([wrong])


# ------------------------------------------------------------ query batches
@pytest.mark.parametrize("transfer", ["float32", "int8", "int4"])
def test_run_queries_matches_per_batch_evaluation(ckpts, batches, transfer):
    """Mirror of test_run_queries_matches_per_batch_evaluation: each query
    batch's metrics equal the batch run alone (a zero-window video, a
    one-window video, text counts that differ by batch) and the JAX
    run_queries; split halves; one result a group for all q rows; the
    corpus checks."""
    ps, _ = ckpts
    cfg = dict(CFG, group_videos=2, transfer_dtype=transfer)
    ev = FusedAlignEvaluator(_port(ps[0]), AlignEvalConfig(**cfg), device="cpu")
    pq = ev.preload_queries(batches)
    got = ev.run_queries(pq)
    for g, b in zip(got, batches, strict=True):
        want = ev(b)
        assert g["Recall"] == want["Recall"]
        np.testing.assert_allclose(g["AUC"], want["AUC"], atol=1e-6)
    assert len({(m["Recall"], m["AUC"]) for m in got}) > 1
    jev = JaxEvaluator(_jax_model(), ps[0], JaxConfig(**cfg))
    for g, w in zip(got, jev.run_queries(jev.preload_queries(batches)), strict=True):
        _close(g, w)
    pendings = ev.dispatch_queries(pq)
    assert [ev.reduce_preloaded(p, pq) for p in pendings] == got
    outs = {id(rec[-1]._stack) for p in pendings for rec in p}
    assert len(outs) == len(pq.entries) == 3
    other = [dict(it, video=it["video"] + 1.0) for it in batches[0]]
    with pytest.raises(ValueError, match="one corpus"):
        ev.preload_queries([batches[0], other])
    with pytest.raises(ValueError, match="group counts"):
        ev.preload_queries([batches[0], batches[0][:3]])
    with pytest.raises(ValueError):
        ev.preload_queries([])


@pytest.mark.parametrize("head", [True, False])
def test_run_queries_head_mode(batches, head):
    """Mirror of test_run_queries_head_mode_and_multi_device (one device):
    the alignability-head protocol and the window-max one, against the
    batches run alone and the JAX run_queries."""
    params = _params(5, head=1)
    cfg = dict(CFG, group_videos=2, use_alignability_head=head)
    ev = FusedAlignEvaluator(_port(params, head=1), AlignEvalConfig(**cfg), device="cpu")
    got = ev.run_queries(ev.preload_queries(batches))
    jev = JaxEvaluator(_jax_model(head=1), params, JaxConfig(**cfg))
    want = jev.run_queries(jev.preload_queries(batches))
    for g, w, b in zip(got, want, batches, strict=True):
        _close(g, w)
        lone = ev(b)
        assert g["Recall"] == lone["Recall"]
        np.testing.assert_allclose(g["AUC"], lone["AUC"], atol=1e-6)


def test_predict_queries_matches_streaming_predict(ckpts, batches):
    """Mirror of test_predict_queries_matches_streaming_predict: each batch
    equals predict(batch), but for the documented edge (a zero-window video
    reports align_score 0 where predict reports NEG_FILL; 'score' carries
    the sentinel on both), and the JAX predict_queries."""
    ps, _ = ckpts
    cfg = dict(CFG, group_videos=2)
    ev = FusedAlignEvaluator(_port(ps[0]), AlignEvalConfig(**cfg), device="cpu")
    got = ev.predict_queries(ev.preload_queries(batches))
    jev = JaxEvaluator(_jax_model(), ps[0], JaxConfig(**cfg))
    want = jev.predict_queries(jev.preload_queries(batches))
    for bi, b in enumerate(batches):
        _close_preds(got[bi], want[bi])
        for vi, (g, r) in enumerate(zip(got[bi], ev.predict(b), strict=True)):
            sentinel = r["score"] <= NEG_FILL * 0.5
            np.testing.assert_allclose(g["score"], r["score"], atol=1e-5)
            np.testing.assert_array_equal(g["argmax"][~sentinel], r["argmax"][~sentinel])
            if (bi, vi) == (1, 1):
                assert sentinel.all()
                np.testing.assert_array_equal(g["align_score"], 0.0)
                np.testing.assert_array_equal(r["align_score"], NEG_FILL)
            else:
                np.testing.assert_allclose(g["align_score"], r["align_score"], atol=1e-5)


# --------------------------------------------------------------- preproject
@pytest.mark.parametrize("transfer", TRANSFERS)
@pytest.mark.parametrize("head", [0, 1])
def test_preproject_resident_matches_unsplit(items, head, transfer):
    """Mirror of test_preproject_resident_matches_unsplit: cfg.preproject
    (the input stages run once at preload) equals the unsplit resident
    sweep and the JAX preprojected one, for every transfer dtype, head on
    and off."""
    params = _params(11 + head, head=head)
    cfg = dict(CFG, group_videos=3, transfer_dtype=transfer, use_alignability_head=bool(head))
    tm = _port(params, head=head)
    ev = FusedAlignEvaluator(tm, AlignEvalConfig(**cfg), device="cpu")
    pp = FusedAlignEvaluator(tm, AlignEvalConfig(**cfg, preproject=True), device="cpu")
    pre = pp.preload(items)
    got = pp.run_preloaded(pre)
    _close(got, ev.run_preloaded(ev.preload(items)))
    jpp = JaxEvaluator(_jax_model(head), params, JaxConfig(**cfg, preproject=True))
    _close(got, jpp.run_preloaded(jpp.preload(items)))
    video = pre.entries[-1][2][0]  # the resident video buffer is width-d now
    assert video.shape[1] == ARCH["width"] and video.dtype == torch.float32


def test_preproject_queries_and_guards(ckpts, batches):
    """The query path under preproject (metrics and predictions) equals the
    unsplit one; the guards: streaming under preproject, the weights pin
    after update_params, and run_many on a preprojected preload."""
    ps, sds = ckpts
    cfg = AlignEvalConfig(**CFG, group_videos=2)
    ev = FusedAlignEvaluator(_port(ps[0]), cfg, device="cpu")
    pp = FusedAlignEvaluator(_port(ps[0]), dataclasses.replace(cfg, preproject=True),
                             device="cpu")
    qb = [make_query_batch(batches[0], s) for s in range(3)]
    for g, w in zip(pp.run_queries(pp.preload_queries(qb)),
                    ev.run_queries(ev.preload_queries(qb)), strict=True):
        _close(g, w)
    for bp, br in zip(pp.predict_queries(pp.preload_queries(qb)),
                      ev.predict_queries(ev.preload_queries(qb)), strict=True):
        _close_preds(bp, br)
    with pytest.raises(ValueError, match="resident-serving"):
        pp(batches[0])
    with pytest.raises(ValueError, match="resident-serving"):
        pp.predict(batches[0])
    pre, pq = pp.preload(batches[0]), pp.preload_queries(qb)
    pp.run_preloaded(pre)
    pp.update_params(sds[1])
    with pytest.raises(ValueError, match="preload again"):
        pp.run_preloaded(pre)
    with pytest.raises(ValueError, match="preload again"):
        pp.run_queries(pq)
    pp.run_preloaded(pp.preload(batches[0]))  # a fresh preload takes the new weights
    with pytest.raises(ValueError, match="preproject"):
        pp.run_many(pp.preload(batches[0]), sds)
    ev.update_params(sds[1])  # a preload without preproject holds no weights
    ev.run_preloaded(ev.preload(batches[0]))


def _char_items(dim, n):
    """tests/test_evals.py::_synthetic_video_item's items."""
    out = []
    for s in range(n):
        rng = np.random.RandomState(s)
        vlen, num_text = 120 + 11 * s, 14
        aligned = (rng.rand(num_text) > 0.4).astype(np.int64)
        aligned[0], aligned[1] = 1, 0
        centers = np.sort(rng.rand(num_text)) * (vlen - 10) + 5
        out.append({"video": rng.randn(vlen, dim).astype(np.float32),
                    "start": np.maximum(centers - rng.randint(2, 8, num_text), 0.0),
                    "end": np.minimum(centers + rng.randint(2, 8, num_text), vlen),
                    "aligned": aligned,
                    "text_embed": rng.randn(num_text, dim).astype(np.float32)})
    return out


def test_preproject_int8_compute_combined(items):
    """Mirror of test_preproject_int8_compute_combined (its model, E2D2 width
    32, and items): preproject + matmul_dtype='int8' keeps R@1, moves AUC by
    less than 0.02 (but moves it); with int8_min_cols above every width it
    equals preproject alone exactly. The input stages run outside the int8
    context: the preprojected buffers equal the exact evaluator's bit for
    bit, and on this file's model the sweep meets the JAX one."""
    arch = dict(num_encoder_layers=2, num_joint_layers=2, width=32, heads=4, max_pos=128,
                input_dim=24)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a),
        JaxAligner(**arch, attn_impl="xla").init(
            jax.random.PRNGKey(1), jnp.zeros((1, 8, 24)), jnp.zeros((1, 2, 24)),
            jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool)))
    tm = TemporalAligner(**arch, device="cpu")
    load_tan_params(tm, params)
    char = _char_items(24, 4)
    base = AlignEvalConfig(group_videos=2)

    def run(**fields):
        ev = FusedAlignEvaluator(tm, dataclasses.replace(base, **fields), device="cpu")
        pre = ev.preload(char)
        return ev.run_preloaded(pre), pre

    ref, _ = run()
    pp_ref, pp_pre = run(preproject=True)
    both, both_pre = run(preproject=True, matmul_dtype="int8")
    assert both["Recall"] == ref["Recall"], (both, ref)
    assert abs(both["AUC"] - ref["AUC"]) < 0.02 and both["AUC"] != ref["AUC"], (both, ref)
    assert run(preproject=True, matmul_dtype="int8", int8_min_cols=4096)[0] == pp_ref
    for (_, _, a, _), (_, _, b, _) in zip(pp_pre.entries, both_pre.entries, strict=True):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    # the JAX evaluator under the same mode, on this file's model and items
    params = _params(0)
    cfg = dict(CFG, group_videos=3, preproject=True, matmul_dtype="int8")
    ev = FusedAlignEvaluator(_port(params), AlignEvalConfig(**cfg), device="cpu")
    jev = JaxEvaluator(_jax_model(), params, JaxConfig(**cfg))
    _close(ev.run_preloaded(ev.preload(items)), jev.run_preloaded(jev.preload(items)),
           auc=1e-3)


# ------------------------------------------------------------------ service
def test_service_score_checkpoints(ckpts, items):
    """Mirror of test_alignment_service_score_checkpoints: one {'Recall',
    'AUC'} per checkpoint, equal with a reused resident corpus and a fresh
    upload, equal to the evaluator per checkpoint and to the JAX service."""
    ps, sds = ckpts
    svc = AlignmentService(_port(ps[0]), seq_len=32, transfer_dtype="float32", device="cpu")
    resident = svc.preload_corpus(items)
    got = svc.score_checkpoints(items, sds, resident=resident)
    assert got == svc.score_checkpoints(items, sds)
    ev = FusedAlignEvaluator(svc.model, svc.cfg, device="cpu")
    for sd, g in zip(sds, got):
        ev.update_params(sd)
        assert ev(items) == g
    jsvc = JaxService(_jax_model(), ps[0], seq_len=32, transfer_dtype="float32")
    for g, w in zip(got, jsvc.score_checkpoints(items, ps), strict=True):
        _close(g, w)


def _text_batches(videos, seed, with_ts):
    r = np.random.RandomState(seed)
    batch = []
    for video in videos:
        k, vlen = 5, video.shape[0]
        entry = {"text_embeds": r.randn(k, DIM).astype(np.float32)}
        if with_ts:
            centers = r.rand(k) * (vlen - 6) + 2  # deliberately unsorted
            entry["start"] = np.maximum(centers - 2, 0)
            entry["end"] = np.minimum(centers + 2, vlen)
        batch.append(entry)
    return batch


@pytest.mark.parametrize("with_ts", [True, False])
def test_align_batch_requests_matches_per_request_align(ckpts, with_ts):
    """Mirror of test_align_batch_requests_matches_per_request_align: each
    answer equals align() of that request and the JAX service's answer
    (timestamped: sorted by midpoint and unsorted back; or all texts
    active); the preproject twin; the ValueErrors and raw 'texts'."""
    ps, _ = ckpts
    svc = AlignmentService(_port(ps[0]), seq_len=32, transfer_dtype="float32", device="cpu")
    jsvc = JaxService(_jax_model(), ps[0], seq_len=32, transfer_dtype="float32")
    rng = np.random.RandomState(3)
    videos = [rng.randn(v, DIM).astype(np.float32) for v in (60, 40, 72)]
    tb = [_text_batches(videos, 10 + s, with_ts) for s in range(3)]
    got = svc.align_batch_requests(videos, tb)
    want = jsvc.align_batch_requests(videos, tb)
    assert len(got) == 3 and all(len(g) == 3 for g in got)
    for bi, batch in enumerate(tb):
        for vi, entry in enumerate(batch):
            ref = svc.align(AlignRequest(video=videos[vi], text_embeds=entry["text_embeds"],
                                         start=entry.get("start"), end=entry.get("end")))
            for other in (ref, want[bi][vi]):
                g = got[bi][vi]
                assert g["best_second"] == other["best_second"], (bi, vi)
                for k in ("score", "align_score"):
                    np.testing.assert_allclose(g[k], other[k], atol=1e-5, rtol=1e-5)
    for a, b in zip(got, svc.align_batch_requests(videos, tb, preproject=True)):
        for da, db in zip(a, b):
            assert da["best_second"] == db["best_second"]
            np.testing.assert_allclose(da["score"], db["score"], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="timestamp presence"):
        svc.align_batch_requests(videos, [tb[0], _text_batches(videos, 1, not with_ts)])
    with pytest.raises(ValueError, match="one entry per corpus video"):
        svc.align_batch_requests(videos, [tb[0][:2]])
    half = [{k: v for k, v in e.items() if k != "end"} for e in _text_batches(videos, 2, True)]
    with pytest.raises(ValueError, match="BOTH"):
        svc.align_batch_requests(videos, [half])
    raw = [dict(e, text_embeds=None, texts=["a", "b"]) for e in tb[0]]
    with pytest.raises(ValueError, match="attach tokenizer"):  # no tower attached
        svc.align_batch_requests(videos, [raw])


# ------------------------------------------------------ no host read-back
@pytest.mark.parametrize("path", ["preloaded", "many", "queries"])
def test_dispatch_reads_nothing_back(ckpts, items, batches, monkeypatch, path):
    """dispatch_preloaded / dispatch_many / dispatch_queries queue the sweep
    with no read-back to the host: with Tensor.cpu, .item, .tolist and
    .numpy raising, dispatching succeeds; only the reducer, after the patch
    is undone, reads, and it reads the same metrics as the run_* call."""
    ps, sds = ckpts
    ev = FusedAlignEvaluator(_port(ps[0]), AlignEvalConfig(**CFG, group_videos=2),
                             device="cpu")
    if path == "preloaded":
        handle = ev.preload(items)
        dispatch, want = ev.dispatch_preloaded, [ev.run_preloaded(handle)]
    elif path == "many":
        handle = ev.preload(items)
        stacked = ev.stack_checkpoints(sds)
        dispatch, want = (lambda h: ev.dispatch_many(h, stacked)), ev.run_many(handle, stacked)
    else:
        handle = ev.preload_queries(batches)
        dispatch, want = ev.dispatch_queries, ev.run_queries(handle)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read-back during dispatch")

    with monkeypatch.context() as m:
        for name in ("cpu", "item", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        pending = dispatch(handle)
    pendings = [pending] if path == "preloaded" else pending
    assert [ev.reduce_preloaded(p, handle) for p in pendings] == want
