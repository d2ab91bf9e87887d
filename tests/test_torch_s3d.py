"""The port's S3D-G backbone, text module, converters, optimizer group and
finetune step against the JAX package, on the CPU.

Weights are the seeded MIL-NCE-layout state of ``tools/synth_htm_aa.py``
(``tests/torch_s3d_common.py``), converted by each package's own
converter; the JAX model's ``init`` is never called (it takes about a
minute on this CPU). Each JAX reference is computed once per module.

Tolerances: frozen BN (eval, --freezeBN) float32 within 1e-4 of max|JAX|;
the step's loss and metrics 1e-5 relative, grads (first moments) 1e-4 of
the largest, parameters after the step 1e-5 of the largest with Adam eps
1e-3.
Under ``train_bn`` a BN channel normalizes over 8-36 positions at these
clip sizes, and float32 rounding (the fast variance's cancellation, the
reductions' order) grows through the randomly weighted trunk: there the
two packages agree to 1e-9 in float64 (outputs, stats and grads of the
model; the whole step in tests/test_torch_s3d_train.py), and in float32
the port is held against the JAX package's float32 at fixed limits about
three times the readings (output 5e-4, stats 1.5e-3 of max); the float32
step is held on its loss, metrics, stats, the heads' grads (1e-3 of their
max) and the direction of the trunk's grads (Adam's normalized update
would turn their spread into lr-sized parameter differences: parameters
are compared under --freezeBN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.models.s3d import S3D as JaxS3D
from exoground_tpu.models.s3d import _same_maxpool as jax_same_maxpool
from exoground_tpu.models.s3d import sentence_embedding_forward as jax_sentence
from exoground_tpu.models.s3d import space_to_depth_3d as jax_s2d
from exoground_tpu.train.checkpoint import save_state as jax_save_state
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFused
from exoground_tpu.train.optim import make_optimizer as jax_chain
from exoground_tpu.train.optim import weight_decay_mask as jax_wd_mask
from exoground_tpu.utils.convert import convert_s3d_state_dict as jax_convert
from exoground_tpu.utils.convert import convert_sentence_embedding_from_s3d as jax_text
from exoground_tpu_torch.models.s3d import EARLY, S3D, same_maxpool, sentence_embedding_forward
from exoground_tpu_torch.models.s3d import space_to_depth_3d
from exoground_tpu_torch.parallel import make_s3d_nce_step
from exoground_tpu_torch.train import (
    ExperimentConfig,
    FusedAdamWEMA,
    S3DTrainer,
    make_optimizer,
    weight_decay_mask,
)
from exoground_tpu_torch.train.checkpoint import checkpoint_format, load_state
from exoground_tpu_torch.utils.convert import (
    convert_s3d_state_dict,
    convert_sentence_embedding_from_s3d,
    s3d_checkpoint_from_jax,
    s3d_state_dict_from_jax,
)
from tests.torch_s3d_common import (  # noqa: F401 (few_threads: an autouse fixture)
    D,
    OPT,
    few_threads,
    clips,
    port_optimizer,
    port_state,
    reference_states,
    tokens,
)
from tests.torch_s3d_jax import hold_train_bn_step, jax_run, named, port_tree, rel, torch_layout

def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


SHAPES = {"b2_t4_48": (2, 4, 48, 48, 3), "b1_t8_40": (1, 8, 40, 40, 3)}
GRAD_SHAPE = "b2_t4_48"  # the model's grads in float64 at this shape
STEP_CLIPS = (4, 1, 4, 48, 48, 3)


@pytest.fixture(scope="module")
def refs():
    trunk, text = reference_states()
    jv = jax_convert(trunk)
    model, params, stats = port_state()
    return dict(trunk=trunk, text=text, jv=jv, jt=jax_text(text), model=model, params=params,
                stats=stats)


# --------------------------------------------------------------- the trunk
def test_space_to_depth_matches_the_reference_order():
    """NCDHW space-to-depth against the reference's torch formula (s3dg.py:
    312-319) written in numpy, and against the JAX package's NDHWC one."""
    x = np.random.RandomState(0).randn(2, 3, 4, 8, 6).astype(np.float32)
    b, c, t, h, w = x.shape
    ref = x.reshape(b, c, t // 2, 2, h // 2, 2, w // 2, 2).transpose(0, 3, 5, 7, 1, 2, 4, 6)
    ref = ref.reshape(b, 8 * c, t // 2, h // 2, w // 2)
    got = space_to_depth_3d(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    jax_out = np.asarray(jax_s2d(jnp.asarray(x.transpose(0, 2, 3, 4, 1))))
    np.testing.assert_array_equal(got, jax_out.transpose(0, 4, 1, 2, 3))


POOLS = {
    "1x3x3_s122_odd": ((1, 3, 3), (1, 2, 2), (2, 5, 3, 13, 11)),
    "1x3x3_s122_even": ((1, 3, 3), (1, 2, 2), (2, 5, 2, 12, 10)),
    "3x3x3_s1": ((3, 3, 3), (1, 1, 1), (1, 4, 3, 5, 6)),
    "3x3x3_s2_odd": ((3, 3, 3), (2, 2, 2), (1, 4, 5, 7, 9)),
    "2x2x2_s2_odd": ((2, 2, 2), (2, 2, 2), (2, 3, 3, 5, 7)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_same_maxpool_matches_flax(case):
    """TF-SAME pools against flax ``nn.max_pool(padding='SAME')`` on values
    below zero, where a zero or symmetric pad would show."""
    kernel, stride, shape = POOLS[case]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) - 3.0
    got = same_maxpool(torch.from_numpy(x), kernel, stride).numpy()
    want = np.asarray(jax_same_maxpool(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), kernel,
                                       stride)).transpose(0, 4, 1, 2, 3)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(POOLS))
def test_same_maxpool_ordered_backward(case):
    """Under deterministic algorithms the pool's backward adds offset by
    offset (the CUDA backward's atomics refuse that mode): the same
    gradient as PyTorch's own backward, ties included (ReLU zeros, rounded
    values), to the order of the sums."""
    kernel, stride, shape = POOLS[case]
    x = torch.relu(torch.randn(*shape, generator=torch.Generator().manual_seed(2)))
    x = x.round(decimals=1).requires_grad_(True)
    g = torch.randn(same_maxpool(x, kernel, stride).shape,
                    generator=torch.Generator().manual_seed(3))
    (want,) = torch.autograd.grad((same_maxpool(x, kernel, stride) * g).sum(), x)
    torch.use_deterministic_algorithms(True)
    try:
        out = same_maxpool(x, kernel, stride)
        (got,) = torch.autograd.grad((out * g).sum(), x)
    finally:
        torch.use_deterministic_algorithms(False)
    assert out.grad_fn.name().startswith("_OrderedMaxPool")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _x(shape, seed=3):
    return clips(seed, (shape[0], 1) + shape[1:], np.float32)[:, 0]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_frozen_bn_matches_jax(refs, shape):
    """The embedding and the pooled trunk with the running stats, float32."""
    x = _x(SHAPES[shape])
    jm = JaxS3D(num_classes=D)
    emb, pooled = jax.jit(lambda v, x: (jm.apply(v, x), jm.apply(v, x, return_embedding=False)))(
        refs["jv"], x)
    with torch.no_grad():
        got = refs["model"](_ncdhw(x), refs["stats"])
        got_pooled = refs["model"](_ncdhw(x), refs["stats"], return_embedding=False)
    assert got.shape == (x.shape[0], D) and got_pooled.shape == (x.shape[0], 1024)
    assert rel(got, torch.from_numpy(np.array(emb))) <= 1e-4
    assert rel(got_pooled, torch.from_numpy(np.array(pooled))) <= 1e-4


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def train_bn_refs(refs):
    """Per shape: the JAX model under train_bn in float64 (output, new stats
    and the grads of sum(output * w)) and in float32 (output, new stats)."""
    jm = JaxS3D(num_classes=D)
    out = {}
    for name, shape in SHAPES.items():
        x = _x(shape)
        w = np.random.RandomState(4).randn(shape[0], D)

        def loss(p, stats, x):
            y, mut = jm.apply({"params": p, "batch_stats": stats}, x, train_bn=True,
                              mutable=["batch_stats"])
            return jnp.sum(y * w), (y, mut["batch_stats"])

        with jax.enable_x64(True):
            jv = _f64(refs["jv"])
            if name == GRAD_SHAPE:
                (_, (y64, s64)), g64 = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                    jv["params"], jv["batch_stats"], x.astype(np.float64))
            else:
                (_, (y64, s64)), g64 = jax.jit(loss)(jv["params"], jv["batch_stats"],
                                                     x.astype(np.float64)), None
            rec = dict(x=x, w=w, y64=np.array(y64), s64=port_tree(s64),
                       g64=g64 and port_tree(g64))
        y32, s32 = jax.jit(lambda v, x: jm.apply(v, x, train_bn=True, mutable=["batch_stats"]))(
            refs["jv"], x)
        rec.update(y32=np.array(y32), s32=port_tree(s32["batch_stats"]))
        out[name] = rec
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_train_bn_float64_matches_jax(refs, train_bn_refs, shape):
    """train_bn in float64: the output, the new running stats and (at
    ``GRAD_SHAPE``) the model's grads, the semantics to rounding."""
    r = train_bn_refs[shape]
    model = S3D(D, device="cpu").double()
    model.load_state_dict({k: v.double() for k, v in
                           convert_s3d_state_dict(refs["trunk"])["params"].items()})
    stats = {k: v.double() for k, v in refs["stats"].items()}
    y, new = model(_ncdhw(r["x"].astype(np.float64)), stats, train_bn=True)
    assert rel(y.detach(), torch.from_numpy(r["y64"])) <= 1e-9
    assert max(rel(new[k], r["s64"][k]) for k in r["s64"]) <= 1e-9
    if r["g64"] is None:
        return
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(r["w"])).sum(),
                                [p for _, p in model.named_parameters()])
    gmax = max(float(g.abs().max()) for g in r["g64"].values())
    err = max(float((g - r["g64"][k]).abs().max()) for k, g in zip(names, grads))
    assert err <= 1e-9 * gmax
    assert set(names) == set(r["g64"])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_train_bn_float32_within_jax_rounding(refs, train_bn_refs, shape):
    """train_bn in float32 against the JAX package's float32: the output
    within 5e-4 of max|JAX| and each new stat within 1.5e-3 of its max,
    about three times the readings at these shapes (1.2e-4-1.7e-4 and
    3.3e-4-5.2e-4: two float32 implementations, whose sums' orders differ,
    each amplify their rounding through train-mode BN; float64 holds the
    semantics)."""
    r = train_bn_refs[shape]
    with torch.no_grad():
        y, new = refs["model"](_ncdhw(r["x"]), refs["stats"], train_bn=True)
    assert rel(y, torch.from_numpy(r["y32"])) <= 5e-4
    for k, want in r["s32"].items():
        assert rel(new[k], want) <= 1.5e-3, k


# ------------------------------------------------------------ text module
def test_sentence_embedding_matches_jax(refs):
    """relu(fc1(embedding)), the max over every word, pads included, fc2;
    the word embedding frozen: no grad reaches it."""
    ids = tokens(5, 4, 7)
    ids[0] = 0  # a row of pads alone
    want = np.asarray(jax_sentence(refs["jt"], jnp.asarray(ids))["text_embedding"])
    params = {k: v.clone().requires_grad_(True) for k, v in
              convert_sentence_embedding_from_s3d(refs["text"]).items()}
    got = sentence_embedding_forward(params, torch.from_numpy(ids).long())["text_embedding"]
    assert rel(got.detach(), torch.from_numpy(want)) <= 1e-6
    g = torch.autograd.grad(got.sum(), list(params.values()), allow_unused=True)
    grads = dict(zip(params, g))
    assert grads["word_embd.weight"] is None and grads["fc1.weight"] is not None


# -------------------------------------------------------------- converters
def test_converters_match_the_jax_package(refs):
    """The reference ``.pth`` layout (DDP ``module.``, ``num_batches_tracked``,
    the text module beside the trunk) through the port's converters equals
    the JAX package's converters bridged by ``s3d_state_dict_from_jax``, and
    loads strictly into the port's S3D."""
    state = {f"module.{k}": torch.from_numpy(v) for k, v in
             {**refs["trunk"], **refs["text"]}.items()}
    state.update({f"module.{k[:-len('running_mean')]}num_batches_tracked": torch.tensor(7)
                  for k in refs["trunk"] if k.endswith("running_mean")})
    port = convert_s3d_state_dict(state)
    bridged = s3d_state_dict_from_jax(refs["jv"])
    for part in ("params", "batch_stats"):
        assert sorted(port[part]) == sorted(bridged[part])
        for k, v in port[part].items():
            assert torch.equal(v, bridged[part][k]), k
            want = torch_layout(k, named(refs["jv"][part])[k])
            assert torch.equal(v, want), k
    S3D(D, device="cpu").load_state_dict(port["params"], strict=True)
    assert sorted(port["batch_stats"]) == sorted(S3D(D, device="cpu").init_batch_stats())
    text = convert_sentence_embedding_from_s3d(state)
    for k, v in named(refs["jt"]).items():
        assert torch.equal(text[k], torch_layout(k, v)), k


def test_decay_mask_and_backbone_group_leaf_for_leaf(refs):
    """The port's weight-decay mask by name equals the JAX mask by path for
    every leaf (BN scales and kernels decay, BN / gating / fc biases do
    not), and the backbone LR group is the ``s3d`` leaves in both."""
    jp = {"s3d": refs["jv"]["params"], "text": refs["jt"]}
    want = named(jax_wd_mask(jp))
    got = weight_decay_mask(refs["params"])
    assert sorted(got) == sorted(want) and len(got) > 300
    assert got == {k: bool(v) for k, v in want.items()}
    assert got["s3d.mixed_4b.conv_b1_b.bn2.weight"] and not got["s3d.mixed_4b.gating_b0.fc.bias"]
    jopt = JaxFused(jp, **OPT)
    scales = {k: float(v) for k, v in named(jopt._lr_scale).items()}
    opt = FusedAdamWEMA(refs["params"], **OPT)
    port_scales = {k: scale or 1.0 for names, _, _, scale in opt._groups for k in names}
    assert port_scales == pytest.approx(scales)
    assert {k for k, s in scales.items() if s != 1.0} == {k for k in got if k.startswith("s3d.")}


def _opt_tree(seed=0):
    r = np.random.RandomState(seed)
    return {"s3d": {"conv": {"kernel": r.randn(2, 3, 4).astype(np.float32)},
                    "bn": {"scale": r.randn(4).astype(np.float32),
                           "bias": r.randn(4).astype(np.float32)}},
            "text": {"fc1": {"kernel": r.randn(3, 5).astype(np.float32),
                             "bias": r.randn(5).astype(np.float32)},
                     "word_embd": r.randn(6, 3).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v, np.float32)})
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = out
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("kind", ["fused", "chain"])
def test_backbone_lr_matches_jax(kind):
    """--lr_backbone: three steps of the fused optimizer and of the optax
    chain against the JAX package's, the s3d leaves on the second LR (2e-6
    relative, the JAX package's own fused-vs-optax tolerance)."""
    kw = dict(OPT, warmup_iterations=1, weight_decay=1e-1)
    tree = _opt_tree()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = JaxFused(jp, **kw) if kind == "fused" else jax_chain(jp, **kw)
    jo = jopt.init(jp)
    p = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    opt = FusedAdamWEMA(p, **kw) if kind == "fused" else make_optimizer(p, **kw)
    o = opt.init(p)
    for i in range(3):
        g = {k: np.random.RandomState(10 + i).randn(*v.shape).astype(np.float32)
             for k, v in sorted(_flat(tree).items())}
        jg = jax.tree_util.tree_map(jnp.asarray, _unflat(g))
        if kind == "fused":
            jp, jo, _ = jopt.step(jp, jo, jg)
        else:
            import optax

            upd, jo = jopt.update(jg, jo, jp)
            jp = optax.apply_updates(jp, upd)
        opt.step(p, o, {k: torch.from_numpy(v) for k, v in g.items()})
    want = _flat(jax.tree_util.tree_map(np.asarray, jp))
    for k, w in want.items():
        np.testing.assert_allclose(p[k].numpy(), w, rtol=2e-6, atol=2e-6, err_msg=k)
    moved = {k: float(np.abs(want[k] - _flat(tree)[k]).max()) for k in want}
    assert moved["s3d.conv.kernel"] > 0 and moved["text.fc1.kernel"] > 0


# ------------------------------------------------------------------- steps
@pytest.fixture(scope="module")
def train_bn_step(refs):
    """One step under train_bn and freeze_early, uint8 clips, the fused
    optimizer (backbone LR): the JAX package's and the port's."""
    batch = {"video": clips(6, STEP_CLIPS), "token": tokens(6, STEP_CLIPS[0])}
    want = jax_run(refs["jv"], refs["jt"], batch, fused=True, train_bn=True)
    model, params, stats = port_state()
    tx = port_optimizer(params, fused=True)
    o = tx.init(params)
    _, _, o, m = make_s3d_nce_step(model, tx, freeze_early=True, train_bn=True)(
        params, stats, o, {k: torch.from_numpy(v) for k, v in batch.items()})
    return want, dict(metrics=m, params=params, mu=o.mu, stats=stats, opt=o)


def test_s3d_nce_step_train_bn_uint8_matches_jax(train_bn_step):
    want, got = train_bn_step
    hold_train_bn_step(got["metrics"], got["mu"], got["stats"], want)


def test_jax_s3d_checkpoint_resumes_into_the_port(refs, train_bn_step, tmp_path):
    """A JAX ``S3DTrainer`` checkpoint (its ``_ckpt_state``: s3d / text
    parameters, the fused optimizer's state, batch_stats) written by the JAX
    ``save_state``: the port tells it apart, bridges it and resumes from it
    bit for bit (parameters, moments, stats, count)."""
    want, _ = train_bn_step
    path = str(tmp_path / "epoch0.pth.tar")
    jax_save_state(path, {"epoch": 0, "state_dict": want["tree"], "best_acc": 2.5,
                          "optimizer": want["opt"], "iteration": 1, "batch_stats": want["bs"]})
    assert checkpoint_format(path) == "flax_msgpack"
    blob = s3d_checkpoint_from_jax(load_state(path))
    cfg = ExperimentConfig(dataset="htm-aa", model="s3d", lr=OPT["lr"], freezeBN=False)
    model, _, _ = port_state()
    tr = S3DTrainer(model, cfg, convert_sentence_embedding_from_s3d(refs["text"]),
                    iters_per_epoch=5, device="cpu")
    tr.load_checkpoint(path, mode="resume")
    assert (tr.iteration, tr.start_epoch, tr.best_acc, tr.opt_state.count) == (1, 1, 2.5, 1)
    for name, got, ref in (("params", tr.params, want["params"]),
                           ("mu", tr.opt_state.mu, want["mu"]),
                           ("stats", tr.batch_stats, want["stats"])):
        assert sorted(got) == sorted(ref), name
        for k, v in got.items():
            assert torch.equal(v, ref[k]), (name, k)
    assert sorted(blob["batch_stats"]) == sorted(tr.batch_stats)


def test_s3d_scan_steps_matches_the_jax_scan(refs):
    """scan_steps=2 under --freezeBN, float32 clips, the fused optimizer
    (backbone LR): the port's ``ScanStep`` (on the CPU its eager loop) equals
    two single steps bit for bit and the JAX scan within the step
    tolerances; the frozen stats stay as they were."""
    n = 2
    batches = {"video": np.stack([clips(7 + i, STEP_CLIPS, np.float32) for i in range(n)]),
               "token": np.stack([tokens(7 + i, STEP_CLIPS[0]) for i in range(n)])}
    want = jax_run(refs["jv"], refs["jt"], batches, fused=True, train_bn=False, scan=n)
    runs = []
    for scan in (n, None):
        model, params, stats = port_state()
        tx = port_optimizer(params, fused=True)
        o = tx.init(params)
        step = make_s3d_nce_step(model, tx, freeze_early=True, scan_steps=scan)
        tb = {k: torch.from_numpy(v) for k, v in batches.items()}
        if scan:
            _, _, o, m = step(params, stats, o, tb)
        else:
            ms = [step(params, stats, o, {k: v[i] for k, v in tb.items()})[3] for i in range(n)]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((m, params, o, stats))
    (m, params, o, stats), (m1, params1, o1, _) = runs
    assert o.count == o1.count == n
    for k in m:
        assert torch.equal(m[k], m1[k]), k
    for k in params:
        assert torch.equal(params[k], params1[k]) and torch.equal(o.mu[k], o1.mu[k]), k
    for k, w in want["metrics"].items():
        assert w.shape == (n,)
        np.testing.assert_allclose(m[k].numpy(), w, rtol=1e-5, atol=1e-8, err_msg=k)
    pmax = max(float(w.abs().max()) for w in want["params"].values())
    for k, w in want["params"].items():
        assert float((params[k] - w).abs().max()) <= 1e-5 * pmax, k
    gmax = max(float(v.abs().max()) for v in want["mu"].values())
    assert max(float((o.mu[k] - v).abs().max()) for k, v in want["mu"].items()) <= 1e-4 * gmax
    for k, v in want["stats"].items():
        assert torch.equal(stats[k], v), k


def test_s3d_step_bfloat16_keeps_updated_stats_float32(refs):
    """--amp under train_bn: the forward in bfloat16, the updated stats
    float32 (a bfloat16 round trip would lose the momentum's small steps),
    the loss finite; frozen, the stats stay as they were."""
    batch = {"video": torch.from_numpy(clips(9, (2, 1, 2, 32, 32, 3))),
             "token": torch.from_numpy(tokens(9, 2))}
    for train_bn in (True, False):
        model, params, stats = port_state()
        before = {k: v.clone() for k, v in stats.items()}
        tx = port_optimizer(params, fused=True)
        o = tx.init(params)
        step = make_s3d_nce_step(model, tx, compute_dtype="bfloat16", train_bn=train_bn)
        _, _, o, m = step(params, stats, o, batch)
        assert np.isfinite(float(m["loss"]))
        assert all(v.dtype == torch.float32 for v in stats.values())
        assert all(p.dtype == torch.float32 for p in params.values())
        changed = [k for k in stats if not torch.equal(stats[k], before[k])]
        assert bool(changed) == train_bn
        if train_bn:  # the early blocks' stats are frozen under freeze_early
            assert not any(k.split(".")[0] in EARLY for k in changed)


def test_s3d_step_keeps_float32_convolutions_in_float32():
    """PyTorch lets cuDNN take TF32 for float32 convolutions by default: the
    step switches TF32 off for cuDNN and matmul in its forward and its
    backward, and leaves the flags as it found them."""
    model, params, stats = port_state()
    seen = []

    def record(*_):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    def on_forward(module, args, out):
        record()
        out.register_hook(record)  # runs in the backward

    model.fc.register_forward_hook(on_forward)
    tx = port_optimizer(params, fused=True)
    o = tx.init(params)
    batch = {"video": torch.from_numpy(clips(9, (2, 1, 2, 32, 32, 3))),
             "token": torch.from_numpy(tokens(9, 2))}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        make_s3d_nce_step(model, tx, train_bn=True)(params, stats, o, batch)
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert seen == [(False, False), (False, False)]
    assert after == (True, True)
