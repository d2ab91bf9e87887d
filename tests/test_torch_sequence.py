"""The port's sequence parallelism against the JAX package's, on the CPU.

One gloo pool a world size (W = 2 and 4 ranks, spawned once for the module,
each rank running every case of ``tests/torch_sequence_cases.py``) against
the JAX functions over ``make_mesh(8)``, the suite's 8 CPU devices, and the
single-device references, on the same numpy-seeded weights and inputs, at
the JAX tests' shapes and bars (tests/test_parallel.py:383-570):

* ring attention with padded keys (b2 h4 s64 d16, the last 9 keys of batch
  1 padded) and q = k = v (b1 h2 s128 d8) against the full softmax and the
  JAX ``sequence_sharded_self_attention``, at 2e-5;
* the dual sim (width 32, 2 + 2 layers, 4 heads, dv 24, dt 16) against the
  JAX model path (``text_visual_sim``'s last stage) and the JAX
  ``sequence_parallel_dual_sim``, at 3e-5; against the model path, a
  ragged video (17 padded frames) and an interpolated position table
  (``max_pos`` 64) at S 101, which neither world divides, so that the
  internal padding is reached, and the joint sim with both masks (2 + 3
  layers);
* every rank returns the same global result, and each case issued W ring
  rotations a layer (``ppermute``) and one gather an output;
* world 1 without a group, in this process; a tensor that requires grad
  raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.parallel import make_mesh as jax_make_mesh
from exoground_tpu.parallel import sequence as jseq
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.parallel import (
    make_mesh,
    ring_attention,
    sequence_parallel_sim,
    sequence_sharded_self_attention,
)
from exoground_tpu_torch.parallel.mesh import free_port
from exoground_tpu_torch.utils.convert import load_tan_params
from tests import torch_sequence_cases

DV, DT = 24, 16
MODEL = dict(width=32, heads=4, attn_impl="xla")
ATTN_TOL, SIM_TOL = 2e-5, 3e-5


@functools.lru_cache(maxsize=None)
def _params(layers, joint, max_pos, seed):
    """Numpy draws in the JAX TemporalAligner's tree (LayerNorm scales near
    1, the rest at the init scales)."""
    jm = JaxAligner(num_encoder_layers=layers, num_joint_layers=joint, max_pos=max_pos,
                    **MODEL)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, DV)),
                            jnp.zeros((1, 2, DT)), jnp.zeros((1, 8), bool),
                            jnp.zeros((1, 2), bool))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 or "pos_embed" in name
                    else sd.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _attn_inputs(name):
    if name == "attn_padded":
        rng = np.random.RandomState(0)
        q, k, v = (rng.randn(2, 4, 64, 16).astype(np.float32) for _ in range(3))
        mask = np.zeros((2, 64), bool)
        mask[1, -9:] = True
        return dict(q=q, k=k, v=v, mask=mask)
    q = np.random.RandomState(1).randn(1, 2, 128, 8).astype(np.float32)
    return dict(q=q, k=q, v=q)


# the sim cases also held against the JAX sequence function over 8 devices
JAX_SEQ_CASES = ("dual",)
SIMS = {  # name: (batch, length, texts, layers, joint layers, max_pos, seed, options)
    "dual": (1, 128, 5, 2, 2, 256, 0, dict(dual_only=True)),
    "ragged": (2, 101, 4, 2, 2, 256, 7, dict(dual_only=True, vpad=(1, 17))),
    "interpolated": (1, 101, 4, 2, 2, 64, 9, dict(dual_only=True, interpolate_from=64)),
    "joint": (2, 120, 5, 2, 3, 256, 3, dict(vpad=(0, 11), tpad=(1, 2))),
}


def _sim_inputs(name):
    b, s, k, layers, joint, max_pos, seed, opt = SIMS[name]
    rng = np.random.RandomState(seed)
    video = rng.randn(b, s, DV).astype(np.float32)
    text = rng.randn(k, DT).astype(np.float32)
    kw = dict(video=video, text=text, params=_params(layers, joint, max_pos, seed),
              model=dict(MODEL, num_encoder_layers=layers, num_joint_layers=joint,
                         max_pos=max_pos, video_dim=DV, text_dim=DT))
    if opt.get("dual_only"):
        kw["dual_only"] = True
    else:
        kw["num_joint_layers"] = joint
    if "interpolate_from" in opt:
        kw["interpolate_from"] = opt["interpolate_from"]
    if "vpad" in opt:
        row, n = opt["vpad"]
        kw["video_padding_mask"] = np.zeros((b, s), bool)
        kw["video_padding_mask"][row, -n:] = True
    if "tpad" in opt:
        row, n = opt["tpad"]
        kw["text_padding_mask"] = np.zeros((b, k), bool)
        kw["text_padding_mask"][row, -n:] = True
    return kw


def _spec():
    spec = {name: ("attn", _attn_inputs(name)) for name in ("attn_padded", "attn_qkv")}
    spec.update({name: ("sim", _sim_inputs(name)) for name in SIMS})
    return spec


@functools.lru_cache(maxsize=None)
def _jax_refs(name):
    """{key: (single-device reference, the JAX function over 8 devices or
    None)}, each jitted (the JAX functions run op by op otherwise, ~10x
    slower); the JAX sequence function for the attention and dual cases."""
    kind, kw = _spec()[name]
    mesh = jax_make_mesh(8)
    if kind == "attn":
        q, k, v = (jnp.asarray(kw[x]) for x in "qkv")
        mask = jnp.asarray(kw.get("mask", np.zeros((q.shape[0], q.shape[2]), bool)))
        s = jnp.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
        s = jnp.where(mask[:, None, None, :], -1e30, s)
        ref = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)
        seq = jax.jit(functools.partial(jseq.sequence_sharded_self_attention, mesh=mesh))(
            q, k, v, key_padding_mask=mask)
        return {"out": (np.asarray(ref), np.asarray(seq))}
    _, _, _, layers, joint, max_pos, _, _ = SIMS[name]
    jm = JaxAligner(num_encoder_layers=layers, num_joint_layers=joint, max_pos=max_pos,
                    **MODEL)
    b, s = kw["video"].shape[:2]
    k = kw["text"].shape[0]
    vmask = jnp.asarray(kw.get("video_padding_mask", np.zeros((b, s), bool)))
    tmask = jnp.asarray(kw.get("text_padding_mask", np.zeros((b, k), bool)))
    video, text = jnp.asarray(kw["video"]), jnp.asarray(kw["text"])
    model = jax.jit(functools.partial(jm.apply, method=JaxAligner.text_visual_sim,
                                      interpolate_from=kw.get("interpolate_from")))(
        {"params": kw["params"]}, video, jnp.broadcast_to(text[None], (b, k, DT)),
        video_padding_mask=vmask, lang_padding_mask=tmask)
    keys = ("dual-sim",) if kw.get("dual_only") else ("dual-sim", "sim")
    if name not in JAX_SEQ_CASES:
        return {key: (np.asarray(model[key][:, -1]), None) for key in keys}
    seq = jax.jit(functools.partial(
        jseq.sequence_parallel_sim, mesh=mesh, num_encoder_layers=layers,
        num_joint_layers=0 if kw.get("dual_only") else joint, heads=MODEL["heads"],
        interpolate_from=kw.get("interpolate_from")))(
        kw["params"], video, text, video_padding_mask=vmask,
        text_padding_mask=tmask if "text_padding_mask" in kw else None)
    return {key: (np.asarray(model[key][:, -1]), np.asarray(seq[key])) for key in keys}


def _check(name, got):
    """``got`` (one rank's or the in-process results) against the JAX
    references: the single-device one on the valid rows, the JAX function
    over 8 devices (where computed) on every row."""
    kind, kw = _spec()[name]
    tol = ATTN_TOL if kind == "attn" else SIM_TOL
    refs = _jax_refs(name)
    assert set(got) - {"issued"} == set(refs), name
    for key, (ref, seq) in refs.items():
        valid = ~kw["video_padding_mask"] if "video_padding_mask" in kw else slice(None)
        np.testing.assert_allclose(got[key][valid], ref[valid], rtol=0, atol=tol,
                                   err_msg=f"{name} {key} vs the model path")
        if seq is not None:
            np.testing.assert_allclose(got[key], seq, rtol=0, atol=tol,
                                       err_msg=f"{name} {key} vs the JAX sequence function")


def _rotations(name, w):
    """(ring rotations, gathers) a case issues at world ``w``."""
    kind, kw = _spec()[name]
    if kind == "attn":
        return w, 1
    layers, joint = SIMS[name][3:5]
    return w * (layers + (0 if kw.get("dual_only") else joint)), 1 if kw.get("dual_only") else 2


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Both pools started together; the JAX references computed while their
    ranks run."""
    spec, started = _spec(), {}
    for w in (2, 4):
        d = tmp_path_factory.mktemp(f"seq{w}")
        started[w] = (d, mp.start_processes(torch_sequence_cases.run, nprocs=w, join=False,
                                            start_method="spawn",
                                            args=(w, free_port(), spec, str(d))))
    for name in spec:
        _jax_refs(name)
    out = {}
    for w, (d, ctx) in started.items():
        while not ctx.join():
            pass
        out[w] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(w)]
    return out


CASE_NAMES = ["attn_padded", "attn_qkv", *SIMS]


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_ranks_match_jax(pools, w, name):
    ranks = pools[w]
    _check(name, ranks[0][name])
    rot, gathers = _rotations(name, w)
    for r, res in enumerate(ranks):
        for key in res[name]:
            if key != "issued":  # every rank holds the same global result
                np.testing.assert_array_equal(res[name][key], ranks[0][name][key],
                                              err_msg=f"rank {r} {key}")
        assert res[name]["issued"] == dict(all_reduce=0, all_gather=gathers, reduce_scatter=0,
                                           broadcast=0, ppermute=rot), (r, res[name]["issued"])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_world_one_without_a_group(name):
    mesh = make_mesh()
    assert (mesh.world, mesh.grouped) == (1, False)
    kind, kw = _spec()[name]
    got = torch_sequence_cases.run_case(mesh, kind, kw)
    _check(name, got)
    assert not any(got["issued"].values())


def test_forward_only_and_argument_checks():
    kw = _sim_inputs("joint")
    tm = TemporalAligner(**kw["model"], device="cpu")
    load_tan_params(tm, {"params": kw["params"]})
    video, text = torch.from_numpy(kw["video"]), torch.from_numpy(kw["text"])
    with pytest.raises(ValueError, match="forward only"):
        sequence_parallel_sim(tm, video.requires_grad_(), text)
    q = torch.randn(1, 2, 8, 4, requires_grad=True)
    with pytest.raises(ValueError, match=r"forward only: \['q'\]"):
        ring_attention(q, q.detach(), q.detach())
    with pytest.raises(ValueError, match="forward only"):
        sequence_sharded_self_attention(q, q, q)
    video.requires_grad_(False)
    with pytest.raises(ValueError, match="4 joint layers asked of a model with 3"):
        sequence_parallel_sim(tm, video, text, num_joint_layers=4)
    with pytest.raises(ValueError, match="heads=8"):
        sequence_parallel_sim(tm, video, text, heads=8)
