"""The port's grounding-family training against the JAX package, on the CPU.

* ``egoexo_loss`` for view_invariant, grounding and joint (with and without
  same-view negatives, center/duration and start/end targets,
  ``test_egovlp``, ``only_same_view_negative``) against the JAX function on
  the same seeded inputs: every entry of the loss dict and the returned map
  at 1e-5 relative (1e-6 absolute); against ``tests/golden/
  grounding_loss.npz`` at the JAX golden test's own tolerances.
* ``cross_view_info_nce``, ``l1_cosine_metrics``, ``symmetric_info_nce`` and
  ``position_embedding_sine_from_mask`` against the JAX functions at 1e-5
  relative (1e-6 absolute; the similarity matrix 1e-5 of its largest
  entry).
* The train step of each model kind (``ViewInvariantMLP``,
  ``GroundingModel`` with its frozen MLP pre-pass, ``ExoGroundingTransformer``
  with distillation and same-view negatives; 1 + 1 layers, width 64, 8
  heads, 32-d inputs) against ``make_grounding_train_step`` on a one-device
  mesh, after 1 and 3 steps, at tests/test_torch_train.py's tolerances:
  metrics 1e-4 relative, first moments 1e-4 of their largest entry,
  parameters 2e-6 absolute, with ``random_pos_start=0`` and Adam eps 1e-3
  for the reason given there. The bf16 step keeps float32 masters and
  moments and its metrics stay within 2e-2 relative of the JAX bf16 step's.
* The replayed runner's CPU loop (``scan_steps=3``) equals three single
  steps bit for bit, drawing fresh pos starts each step; a forward handed
  its starts as a tensor equals the forward that draws them.
* The eval step of each kind against ``make_grounding_eval_step`` on a
  batch with a padding row (``row_valid`` 0, all narrations padded) and on
  a ragged batch of 3 rows: every
  scalar at 1e-5 relative (1e-6 absolute), the weights equal, the IoU map at
  1e-5 absolute.
* The weight-decay mask on the grounding family's names against the JAX
  mask on the same trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.losses import grounding as jgnd
from exoground_tpu.losses import infonce as jinfonce
from exoground_tpu.models.grounding import ExoGroundingTransformer as JaxExo
from exoground_tpu.models.grounding import GroundingModel as JaxGrounding
from exoground_tpu.models.vi_encoder import ViewInvariantMLP as JaxVIMLP
from exoground_tpu.ops.pos_embed import position_embedding_sine_from_mask as jax_sine_mask
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel.train_step import make_grounding_eval_step as jax_make_eval
from exoground_tpu.parallel.train_step import make_grounding_train_step as jax_make_step
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu.train.optim import weight_decay_mask as jax_wd_mask
from exoground_tpu_torch.losses import grounding as tgnd
from exoground_tpu_torch.losses import infonce as tinfonce
from exoground_tpu_torch.models import ExoGroundingTransformer, GroundingModel
from exoground_tpu_torch.models.vi_encoder import ViewInvariantMLP
from exoground_tpu_torch.ops.pos_embed import position_embedding_sine_from_mask
from exoground_tpu_torch.parallel import make_grounding_eval_step, make_grounding_train_step
from exoground_tpu_torch.train import FusedAdamWEMA, weight_decay_mask
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    grounding_state_dict_from_jax,
    load_grounding_params,
)
from tests import golden_common as G
from tests.test_torch_small import jax_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

C, W, B, T, N, V = 32, 64, 4, 16, 6, 3
TRUNK = dict(num_encoder_layers=1, num_decoder_layers=1, video_embed_dim=C, text_embed_dim=C,
             feature_dim=W, random_pos_start=0)
OPT = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=0)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def _batch(seed, kind="joint", svn=True, b=B):
    """A seeded grounding-family batch in the trainer's prepared layout."""
    rng = np.random.RandomState(seed)
    starts = (rng.rand(b, N) * 0.5).astype(np.float32)
    ends = (starts + rng.rand(b, N) * 0.4).astype(np.float32)
    npad = np.zeros((b, N), bool)
    npad[0, -2:] = True
    npad[1, -1] = True
    vpad = np.zeros((b, T), bool)
    vpad[2, -3:] = True
    video = rng.randn(b, T, C).astype(np.float32)
    out = {"video_features": video, "narration_features": rng.randn(b, N, C).astype(np.float32),
           "video_padding_mask": vpad, "narration_padding_mask": npad,
           "starts": starts, "ends": ends, "mean": (starts + ends) / 2,
           "duration": np.abs(ends - starts)}
    if kind == "grounding":
        return out
    bank = rng.randn(b, V, T, C).astype(np.float32)
    pos = rng.randint(0, V, (b, T)).astype(np.int32)
    out.update(ego_video_features=bank, view_rank_label=pos,
               view_rank_neg_label=rng.randint(0, V, (b, T)).astype(np.int32),
               ego_video_features_flat=np.take_along_axis(
                   bank.transpose(0, 2, 1, 3), pos[..., None, None], axis=2)[:, :, 0])
    if svn:
        idx = rng.randint(0, T, (b, T))
        out["same_view_neg_feats"] = np.take_along_axis(video, idx[..., None], axis=1)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ losses
LOSS_CASES = {
    "vi": ("view_invariant", dict(use_distill_nce_loss=True), True),
    "vi_no_svn": ("view_invariant", dict(use_distill_nce_loss=True), False),
    "vi_only_svn": ("view_invariant", dict(only_same_view_negative=True), True),
    "vi_test_egovlp": ("view_invariant", dict(test_egovlp=True), False),
    "grounding_cd": ("grounding", dict(), False),
    "grounding_se": ("grounding", dict(use_center_duration=False), False),
    "joint": ("joint", dict(use_distill_nce_loss=True), True),
    "joint_se_no_svn": ("joint", dict(use_distill_nce_loss=True, use_center_duration=False),
                        False),
    "joint_no_distill": ("joint", dict(), True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_egoexo_loss_matches_jax(case):
    kind, flags, svn = LOSS_CASES[case]
    batch = _batch(3, "joint", svn)
    rng = np.random.RandomState(5)
    out = {"interval_preds": rng.rand(B, N, 2).astype(np.float32),
           "high_dim_features": rng.randn(B, T, C).astype(np.float32)}
    jcfg = jgnd.GroundingLossConfig(model=kind, iou_loss_eps=1e-8, **flags)
    tcfg = tgnd.GroundingLossConfig(model=kind, iou_loss_eps=1e-8, **flags)
    jld, jmap = jgnd.egoexo_loss({k: jnp.asarray(v) for k, v in out.items()},
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(batch["narration_padding_mask"]), jcfg)
    tld, tmap = tgnd.egoexo_loss(_torch(out), _torch(batch),
                                 torch.from_numpy(batch["narration_padding_mask"]), tcfg)
    assert set(tld) == set(jld)
    for k in jld:
        _close(tld[k], jld[k], msg=k)
    _close(tmap, jmap, msg="map")


@pytest.mark.parametrize("center_duration", [True, False])
def test_grounding_regression_matches_golden(center_duration):
    z = np.load(f"{G.GOLDEN_DIR}/grounding_loss.npz")
    preds, starts, ends, pad, _ = G.grounding_loss_inputs()
    cfg = tgnd.GroundingLossConfig(use_center_duration=center_duration, iou_loss_eps=1e-8)
    targets = {"mean": (starts + ends) / 2, "duration": np.abs(ends - starts),
               "starts": starts, "ends": ends}
    ld, iou = tgnd.grounding_loss(torch.from_numpy(preds), _torch(targets),
                                  torch.from_numpy(pad), cfg)
    tag = "cd" if center_duration else "se"
    for key in ("loss", "IoU loss", "mean IoU", "IoU>=0.3", "IoU>=0.5"):
        assert abs(float(ld[key]) - float(z[f"{tag}::{key}"])) < 2e-5, key
    np.testing.assert_allclose(iou.numpy()[~pad], z[f"{tag}::iou_map"], atol=1e-5)


@pytest.mark.parametrize("same_view", [False, True])
def test_vi_infonce_matches_golden(same_view):
    z = np.load(f"{G.GOLDEN_DIR}/grounding_loss.npz")
    feats, ego, pos, neg, svn_idx, video = G.vi_infonce_inputs()
    svn = np.take_along_axis(video, svn_idx[..., None], axis=1) if same_view else None
    got = tinfonce.cross_view_info_nce(
        torch.from_numpy(feats), torch.from_numpy(ego), torch.from_numpy(pos),
        torch.from_numpy(neg), same_view_neg_feats=None if svn is None else torch.from_numpy(svn))
    np.testing.assert_allclose(got.numpy(), z[f"vi_{int(same_view)}::nce"], rtol=2e-4, atol=1e-5)
    l1, pc, nc = tinfonce.l1_cosine_metrics(*map(torch.from_numpy, (feats, ego, pos, neg)))
    for got, key in ((l1, "l1"), (pc, "pos_cos"), (nc, "neg_cos")):
        np.testing.assert_allclose(got.numpy(), z[f"vi::{key}"], rtol=1e-4, atol=1e-5)


def test_infonce_family_matches_jax():
    rng = np.random.RandomState(9)
    feats = rng.randn(B, T, C).astype(np.float32)
    bank = rng.randn(B, V, T, C).astype(np.float32)
    pos, neg = rng.randint(0, V, (2, B, T))
    svn = rng.randn(B, T, C).astype(np.float32)
    for only in (False, True):
        want = jinfonce.cross_view_info_nce(feats, bank, pos, neg, same_view_neg_feats=svn,
                                            only_same_view_negative=only)
        got = tinfonce.cross_view_info_nce(
            torch.from_numpy(feats), torch.from_numpy(bank), torch.from_numpy(pos),
            torch.from_numpy(neg), same_view_neg_feats=torch.from_numpy(svn),
            only_same_view_negative=only)
        _close(got, want, msg=f"cross_view only={only}")
    for got, want in zip(
            tinfonce.l1_cosine_metrics(*map(torch.from_numpy, (feats, bank, pos, neg))),
            jinfonce.l1_cosine_metrics(feats, bank, pos, neg)):
        _close(got, want, msg="l1_cosine")
    v, t = rng.randn(2, 8, C).astype(np.float32)
    tl, td = tinfonce.symmetric_info_nce(torch.from_numpy(v), torch.from_numpy(t))
    jl, jd = jinfonce.symmetric_info_nce(v, t)
    _close(tl, jl, msg="symmetric")
    for k in jd:  # sim: 1e-5 of its largest entry (a matmul of 32-d rows)
        _close(td[k], jd[k], atol=1e-5 * float(np.abs(jd[k]).max()), msg=k)


@pytest.mark.parametrize("normalize", [True, False])
def test_position_embedding_sine_from_mask_matches_jax(normalize):
    mask = np.zeros((3, 20), bool)
    mask[1, -5:] = True
    mask[2, :] = True
    got = position_embedding_sine_from_mask(torch.from_numpy(mask), num_pos_feats=32,
                                            normalize=normalize)
    want = jax_sine_mask(jnp.asarray(mask), num_pos_feats=32, normalize=normalize)
    _close(got, want, msg="sine")


# --------------------------------------------------------------- the models
def _models(kind, random_pos_start=0):
    """(JAX model, port model, loss flags) of a model kind."""
    trunk = dict(TRUNK, random_pos_start=random_pos_start)
    if kind == "view_invariant":
        return (JaxVIMLP(video_embed_dim=C), ViewInvariantMLP(C, device="cpu"),
                dict(use_distill_nce_loss=True, same_view_negative=True))
    if kind == "grounding":
        return (JaxGrounding(vi_encoder_type="mlp", **trunk, attn_impl="xla"),
                GroundingModel(vi_encoder_type="mlp", **trunk, device="cpu"), {})
    return (JaxExo(**trunk, use_distill_nce_loss=True, attn_impl="xla"),
            ExoGroundingTransformer(**trunk, use_distill_nce_loss=True, device="cpu"),
            dict(use_distill_nce_loss=True, same_view_negative=True))


def _init_args(kind, batch):
    args = (batch["video_features"], batch["narration_features"],
            batch["video_padding_mask"], batch["narration_padding_mask"])
    kw = {} if kind == "view_invariant" else dict(
        egocentric_video_embed=batch.get("ego_video_features_flat"))
    return args, kw


def _setup(kind, seed=0):
    jm, tm, flags = _models(kind)
    sample = _batch(0, kind)
    args, kw = _init_args(kind, sample)
    jparams = jax_params(jm, *args, seed=seed, **kw)
    load_grounding_params(tm, {"params": jparams})
    return jm, tm, flags, jparams


def _bridge(tree):
    return grounding_state_dict_from_jax({"params": jax.device_get(tree)})


@pytest.fixture(scope="module", params=["view_invariant", "grounding", "joint"])
def grounding_steps(request):
    """3 steps of the JAX step and the port's from the same weights; the
    metrics, parameters and first moments after 1 and 3."""
    kind = request.param
    jm, tm, flags, jparams = _setup(kind)
    mesh = make_mesh(1)
    jtx = JaxFusedAdamWEMA(jparams, eps=1e-3, **OPT)
    jstep = jax_make_step(jm, jgnd.GroundingLossConfig(model=kind, **flags), jtx, mesh)
    jp = replicate(jax.tree_util.tree_map(jnp.copy, jparams), mesh)
    jo = replicate(jtx.init(jparams), mesh)
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = FusedAdamWEMA(p, eps=1e-3, **OPT)
    step = make_grounding_train_step(tm, tgnd.GroundingLossConfig(model=kind, **flags), tx)
    o = tx.init(p)
    tm.train()
    record = {}
    for i in range(3):
        b = _batch(10 + i, kind)
        jp, jo, jmet = jstep(jp, jo, shard_batch(b, mesh), jax.random.PRNGKey(i))
        p, _, o, met = step(p, None, o, _torch(b), torch.Generator().manual_seed(i))
        if i in (0, 2):
            record[i + 1] = (({k: float(v) for k, v in jmet.items()}, _bridge(jp),
                              _bridge(jo.mu)),
                             ({k: float(v) for k, v in met.items()},
                              {k: v.clone() for k, v in p.items()},
                              {k: v.clone() for k, v in o.mu.items()}))
    return kind, record


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(grounding_steps, n_steps):
    kind, record = grounding_steps
    (jmet, jp, jmu), (met, p, mu) = record[n_steps]
    assert set(met) == set(jmet), kind
    for k in jmet:
        np.testing.assert_allclose(met[k], jmet[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert set(jp) == set(p) - set(UNUSED_REFERENCE_KEYS)
    for k, want in jmu.items():
        scale = max(want.abs().max().item(), 1e-12)
        np.testing.assert_allclose(mu[k].numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=f"first moment {k}")
    for k, want in jp.items():
        np.testing.assert_allclose(p[k].numpy(), want.numpy(), rtol=0, atol=2e-6, err_msg=k)
    if kind == "grounding":  # the frozen pre-pass only decays
        assert all(mu[k].abs().max() == 0 for k in mu if k.startswith("vi_encoder."))


def test_bf16_step_keeps_float32_masters_and_tracks_jax():
    jm, tm, flags, jparams = _setup("joint")
    cfg = dict(model="joint", **flags)
    mesh = make_mesh(1)
    jtx = JaxFusedAdamWEMA(jparams, eps=1e-3, **OPT)
    jstep = jax_make_step(jm, jgnd.GroundingLossConfig(**cfg), jtx, mesh,
                          compute_dtype="bfloat16")
    b = _batch(10)
    _, _, jmet = jstep(replicate(jparams, mesh), replicate(jtx.init(jparams), mesh),
                       shard_batch(b, mesh), jax.random.PRNGKey(0))
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = FusedAdamWEMA(p, eps=1e-3, **OPT)
    step = make_grounding_train_step(tm, tgnd.GroundingLossConfig(**cfg), tx,
                                     compute_dtype="bfloat16")
    o = tx.init(p)
    before = {k: v.clone() for k, v in p.items()}
    p, _, o, met = step(p, None, o, _torch(b))
    assert all(v.dtype == torch.float32 for d in (p, o.mu, o.nu) for v in d.values())
    assert any(not torch.equal(p[k], before[k]) for k in p)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=2e-2, atol=1e-3,
                                   err_msg=k)


def test_scan_loop_equals_single_steps_with_fresh_pos_starts():
    """The N-step runner's CPU loop against N single steps, bit for bit,
    with random pos starts drawn (text pos-enc on: two starts a step)."""
    def run(n_fused):
        torch.manual_seed(0)
        tm = ExoGroundingTransformer(**dict(TRUNK, random_pos_start=1), use_text_pos_enc=1,
                                     use_distill_nce_loss=True, device="cpu")
        tm.train()
        p = {k: v.detach() for k, v in tm.named_parameters()}
        tx = FusedAdamWEMA(p, eps=1e-3, **OPT)
        cfg = tgnd.GroundingLossConfig(model="joint", use_distill_nce_loss=True)
        step = make_grounding_train_step(tm, cfg, tx, scan_steps=n_fused)
        o, gen = tx.init(p), torch.Generator().manual_seed(3)
        batches = [_torch(_batch(20 + i)) for i in range(3)]
        if n_fused:
            stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
            assert step.single.n_pos_starts(stacked) == 2
            p, _, o, ms = step(p, None, o, stacked, gen)
            losses = ms["loss"].tolist()
        else:
            losses = []
            for b in batches:
                p, _, o, m = step(p, None, o, b, gen)
                losses.append(float(m["loss"]))
        return p, o, losses, gen

    p1, o1, l1, g1 = run(None)
    p3, o3, l3, g3 = run(3)
    assert l1 == l3 and o1.count == o3.count == 3
    for k in p1:
        assert torch.equal(p1[k], p3[k]), k
        assert torch.equal(o1.mu[k], o3.mu[k]), k
    assert torch.equal(g1.get_state(), g3.get_state())


def test_forward_with_drawn_starts_equals_drawing_forward():
    """``pos_starts`` from ``draw_pos_starts`` reproduce the generator's
    draws in order: the transformer VI pre-pass, text, video, audio."""
    torch.manual_seed(1)
    tm = GroundingModel(vi_encoder_type="transformer", **dict(TRUNK, random_pos_start=1),
                        use_text_pos_enc=1, use_audio=True, audio_embed_dim=24, device="cpu")
    tm.train()
    b = _torch(_batch(4, "grounding"))
    audio = torch.randn(B, T, 24)
    apad = torch.zeros(B, T, dtype=torch.bool)
    assert tm.pos_start_lengths(T, N, True) == (T, N, T, T)
    args = (b["video_features"], b["narration_features"], b["video_padding_mask"],
            b["narration_padding_mask"], audio, apad)
    starts = tm.draw_pos_starts(torch.Generator().manual_seed(7), T, N, True)
    with torch.no_grad():
        want = tm(*args, deterministic=False, generator=torch.Generator().manual_seed(7))
        got = tm(*args, deterministic=False, pos_starts=starts)
        other = tm(*args, deterministic=False, pos_starts=starts + 1)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(other["interval_preds"], want["interval_preds"])


# ----------------------------------------------------------------- the eval
@pytest.mark.parametrize("rows", ["padding_row", "ragged"])
@pytest.mark.parametrize("kind", ["view_invariant", "grounding", "joint"])
def test_eval_step_matches_jax_with_a_padding_row(kind, rows):
    """A padding row (``row_valid`` 0), as the JAX trainer pads a ragged
    batch to its mesh; and a ragged last batch of 3 rows as it is, as the
    port's one device evaluates it."""
    jm, tm, flags, jparams = _setup(kind, seed=1)
    cfg = dict(model=kind, **flags)
    if rows == "ragged":
        b = _batch(30, kind, b=3)
    else:
        b = _batch(30, kind)
        b["narration_padding_mask"][-1] = True  # the padding row: no narration
        b["row_valid"] = np.array([1, 1, 1, 0], np.float32)
    jscal, jious = jax_make_eval(jm, jgnd.GroundingLossConfig(**cfg), make_mesh(1))(
        jparams, shard_batch(b, make_mesh(1)))
    step = make_grounding_eval_step(tm, tgnd.GroundingLossConfig(**cfg))
    scal, ious = step({k: v.detach() for k, v in tm.named_parameters()}, _torch(b))
    assert set(scal) == set(jscal)
    for k in jscal:
        _close(scal[k], jscal[k], msg=k)
    assert float(scal["_n_valid"]) == float(jscal["_n_valid"])
    assert float(scal["_rows"]) == 3.0
    _close(ious, jious, rtol=0, atol=1e-5, msg="ious")


# ------------------------------------------------------------ optimizer mask
@pytest.mark.parametrize("kind", ["view_invariant", "grounding", "joint"])
def test_weight_decay_mask_on_grounding_names_matches_jax(kind):
    """The JAX mask on the JAX tree, carried to the port's names through the
    weight bridge (a constant array per leaf), equals the port's mask."""
    jm, tm, _, jparams = _setup(kind)
    jmask = jax_wd_mask(jparams)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                       jmask, jparams)
    bridged = grounding_state_dict_from_jax({"params": as_arrays})
    mask = weight_decay_mask({k: v for k, v in tm.named_parameters()})
    assert set(bridged) == set(mask) - set(UNUSED_REFERENCE_KEYS)
    for k, arr in bridged.items():
        assert bool(arr.flatten()[0]) == mask[k], k
