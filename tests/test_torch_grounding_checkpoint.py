"""``GroundingService.from_checkpoint`` on the port's own grounding files.

* Two ``EgoExoTrainer`` steps at a small width (1 + 1 layers, width 64,
  32-d inputs), ``save_epoch``, then ``from_checkpoint``: the served
  intervals equal the in-memory model's ``ground_batch`` exactly, for a
  ``GroundingModel`` with its MLP view-invariant pre-pass (the caller
  passes a model with one) and for a joint ``ExoGroundingTransformer``'s
  file served into a ``GroundingModel`` without one (the default's class).
* The default model (the JAX default's fields, no pre-pass) refuses a file
  with a pre-pass, naming the keys that do not fit (``KeyError``); a wrong
  shape is named too (``RuntimeError``, as ``load_state_dict`` raises it).
"""

import numpy as np
import pytest
import torch

from exoground_tpu_torch.evals.bench_items import make_grounding_requests
from exoground_tpu_torch.models import ExoGroundingTransformer, GroundingModel
from exoground_tpu_torch.serve import GroundingService
from exoground_tpu_torch.train import ExperimentConfig
from exoground_tpu_torch.train.trainer import EgoExoTrainer
from tests.test_torch_grounding_train import TRUNK, _batch
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

SVC = dict(seq_len=16, text_bucket=8, device="cpu")


def _trained(kind, tmp_path):
    """A model of ``kind`` after two trainer steps (the first under warmup
    takes lr 0), and its epoch-0 file."""
    torch.manual_seed(0)
    if kind == "grounding":
        model = GroundingModel(vi_encoder_type="mlp", **TRUNK, device="cpu")
    else:
        model = ExoGroundingTransformer(**TRUNK, device="cpu")
    cfg = ExperimentConfig(model=kind, epochs=1, lr=1e-3, print_freq=10,
                           model_path=str(tmp_path))
    tr = EgoExoTrainer(model, cfg, iters_per_epoch=1, device="cpu")
    before = {k: v.clone() for k, v in tr.params.items()}
    for seed in (3, 4):
        batch = _batch(seed, "grounding")
        tr._do_step(tr.to_device({k: batch[k] for k in (
            "video_features", "narration_features", "video_padding_mask",
            "narration_padding_mask", "mean", "duration")}))
    assert any(not torch.equal(before[k], tr.params[k]) for k in before)
    tr.save_epoch(0)
    return model, str(tmp_path / "epoch0.pth.tar")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(model, file) of each kind, trained once for the module."""
    return {kind: _trained(kind, tmp_path_factory.mktemp(kind)) for kind in ("grounding", "joint")}


def _requests():
    return make_grounding_requests(5, 6, video_dim=32, text_dim=32, max_t=16, max_k=11)


@pytest.mark.parametrize("kind", ["grounding", "joint"])
def test_served_checkpoint_equals_the_trained_model(kind, trained):
    model, path = trained[kind]
    torch.manual_seed(1)  # other initial weights: the file must replace every one
    fresh = GroundingModel(vi_encoder_type="mlp" if kind == "grounding" else "none",
                           **TRUNK, device="cpu")
    served = GroundingService.from_checkpoint(path, model=fresh, **SVC)
    reqs = _requests()
    got = served.ground_batch(reqs)
    want = GroundingService(model, **SVC).ground_batch(reqs)
    for g, w in zip(got, want):
        for k in ("start", "end"):
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_default_model_names_the_keys_that_do_not_fit(trained):
    _, path = trained["grounding"]
    with pytest.raises(KeyError, match=r"unexpected \['vi_encoder\.") as err:
        GroundingService.from_checkpoint(path, device="cpu")
    assert "missing ['" in str(err.value)  # the default's deeper layers
    wide = GroundingModel(vi_encoder_type="mlp", **dict(TRUNK, feature_dim=32), device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch for"):
        GroundingService.from_checkpoint(path, model=wide, device="cpu")
