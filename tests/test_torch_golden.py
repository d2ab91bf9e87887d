"""The port's TemporalAligner against the golden fixtures and the bridge.

The fixtures (tests/golden/) hold the reference implementation's outputs for
weights regenerated from numpy seeds (tests/golden_common.py). The port's
module names are the reference's state-dict names, so it loads those weights
with load_state_dict(strict=True) as they are: that includes the full-width
E6D6 fixture, run here on torch alone. Tolerance as tests/test_golden.py:
relative error < 2e-4.
"""

import os

import numpy as np
import torch

from exoground_tpu.utils.convert import convert_tan_state_dict
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.serve import AlignmentService
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    load_reference_state,
    tan_state_dict_from_jax,
)
from tests import golden_common as G


def _rel(a, r):
    return np.abs(np.asarray(a) - r).max() / (np.abs(r).max() + 1e-8)


def test_bridge_is_the_inverse_of_convert_tan_state_dict():
    """convert_tan_state_dict(synth_state) -> tan_state_dict_from_jax gives
    back every array the port's model holds (the reference's unused ``mlp``
    has no JAX counterpart)."""
    z = np.load(os.path.join(G.GOLDEN_DIR, "tan_forward.npz"))
    state = G.synth_state(G.manifest_from_npz(z), seed=7)
    back = tan_state_dict_from_jax({"params": convert_tan_state_dict(state)})
    model = TemporalAligner(num_encoder_layers=2, num_joint_layers=2,
                            use_alignability_head=1, device="cpu")
    held = set(model.state_dict())
    assert set(back) == held - set(UNUSED_REFERENCE_KEYS)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def _golden_model(name, seed, **kw):
    z = np.load(os.path.join(G.GOLDEN_DIR, name))
    model = TemporalAligner(use_alignability_head=1, device="cpu", **kw).eval()
    state = G.synth_state(G.manifest_from_npz(z), seed=seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return z, model


def _check_forward(z, model, arrays):
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in arrays), deterministic=True)
    for key in ("logits_dual", "logits_joint", "dual_logits_alignability",
                "joint_logits_alignability"):
        r = z[f"out::{key}"]
        assert out[key].shape == r.shape, key
        assert _rel(out[key].numpy(), r) < 2e-4, (key, _rel(out[key].numpy(), r))


def test_golden_tan_forward():
    z, model = _golden_model("tan_forward.npz", 7, num_encoder_layers=2,
                             num_joint_layers=2)
    _check_forward(z, model, G.tan_forward_inputs())
    video, lang = G.tan_eval_inputs()
    with torch.no_grad():
        ev = model.text_visual_sim(torch.from_numpy(video), torch.from_numpy(lang))
    for ours, ref in (("sim", "eval_sim_joint"), ("dual-sim", "eval_sim_dual")):
        r = z[f"out::{ref}"]
        assert _rel(ev[ours].numpy().reshape(r.shape), r) < 2e-4, ours


def test_golden_tan_forward_fullscale():
    """E6D6 / width 512 / 8x64 heads / 4096-d inputs / text pos-enc, plus the
    eval entries at a 200-frame global-mode shape with both pos tables
    interpolated from 4096 rows."""
    z, model = _golden_model("tan_forward_fullscale.npz", 17, num_encoder_layers=6,
                             num_joint_layers=6, use_text_pos_enc=1)
    _check_forward(z, model, G.tan_fullscale_inputs())
    video, lang = G.tan_fullscale_eval_inputs()
    with torch.no_grad():
        ev = model.text_visual_sim(torch.from_numpy(video), torch.from_numpy(lang),
                                   interpolate_from=(4096, 4096))
    for ours, ref in (("sim", "eval_sim_joint"), ("dual-sim", "eval_sim_dual"),
                      ("alignability-dual", "eval_alignability_dual"),
                      ("alignability-joint", "eval_alignability_joint")):
        r = z[f"out::{ref}"]
        assert _rel(ev[ours].numpy().reshape(r.shape), r) < 2e-4, ours


def test_reference_checkpoint_loads_strictly(tmp_path):
    """A reference cotrain .pth.tar (DDP 'module.' and EMA-twin prefixes)
    loads into the port's model as it is, target branch."""
    z = np.load(os.path.join(G.GOLDEN_DIR, "tan_forward.npz"))
    state = G.synth_state(G.manifest_from_npz(z), seed=7)
    blob = {"epoch": 3, "state_dict": {
        **{f"module.target.{k}": torch.from_numpy(v) for k, v in state.items()},
        "module.online.ln_text_init.bias": torch.zeros(512),
    }}
    path = tmp_path / "tan.pth.tar"
    torch.save(blob, path)
    loaded = load_reference_state(str(path))
    assert set(loaded) == set(state)
    model = TemporalAligner(num_encoder_layers=2, num_joint_layers=2,
                            use_alignability_head=1, device="cpu")
    model.load_state_dict(loaded, strict=True)
    np.testing.assert_array_equal(model.ln_text_init.bias.detach().numpy(),
                                  state["ln_text_init.bias"])
    svc = AlignmentService.from_checkpoint(str(path), num_layers=2, device="cpu")
    assert svc.model.use_alignability_head and not svc.cfg.use_alignability_head
    np.testing.assert_array_equal(
        svc.model.video_pre_proj.weight.detach().numpy(), state["video_pre_proj.weight"])
