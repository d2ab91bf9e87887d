"""The JAX-written TAN checkpoints committed under
``exoground_tpu_torch/testdata/``, rebuilt from their seed.

The card's machine has no JAX, flax or msgpack, so chip_smoke.py resumes
from files the JAX package wrote here. Each is a JAX ``TANTrainer``'s
``save_epoch`` after 3 cotrain steps of a narrow, shallow aligner (1 + 1
layers, width 32, 24-d video and text) from ``SEED``: one with the fused
optimizer's state, one with the optax chain's ``MultiStepsState`` at
``--backprop_freq 2`` (saved at mini step 1, its accumulator holding the
third mini-batch). Each is written twice from the same state: as the
JAX ``save_state`` writes it (``jax_tan_<layout>.pth.tar``, flax msgpack)
and with the JAX ``save_state_orbax`` (``jax_tan_<layout>.orbax/``, an
orbax checkpoint directory). Adam's eps is 1e-3 (for the reason
tests/test_torch_train.py gives), so a resumed step compares at the train
step's tolerances. tests/test_torch_checkpoint.py rebuilds them and holds
the committed files to the rebuilt ones (the orbax twins by the trees
read: their file names are random).

Write the committed files again with
``JAX_PLATFORMS=cpu python tests/jax_tan_fixtures.py``.
"""

import functools
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "exoground_tpu_torch", "testdata")
SEED = 0
# the aligner's fields (chip_smoke.py's JAX_FIXTURE_MODEL holds the same)
MODEL = dict(num_encoder_layers=1, num_joint_layers=1, width=32, heads=2, max_pos=64,
             use_alignability_head=1, random_pos_start=0)
DIM = 24  # video and text feature width
EPS = 1e-3
LAYOUTS = {"fused": dict(), "multisteps_k2": dict(backprop_freq=2)}
CONFIG = dict(model="cotrain", learn_agreement=1, loss_threshold=0.7, use_alignability_head=1,
              lr=1e-3, momentum_m=0.9, epochs=2, seed=SEED, print_freq=100)
ITERS_PER_EPOCH = 4


def fixture_path(layout: str) -> str:
    return os.path.join(FIXTURE_DIR, f"jax_tan_{layout}.pth.tar")


def orbax_fixture_path(layout: str) -> str:
    return os.path.join(FIXTURE_DIR, f"jax_tan_{layout}.orbax")


def batch(seed: int, b: int = 4, t: int = 16, n: int = 5) -> dict:
    """A raw TAN batch of text features (chip_smoke.py's ``_fixture_batch``
    draws the same)."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, t - 4, (b, n)).astype(np.float32)
    return {"video": rng.randn(b, t, DIM).astype(np.float32),
            "text": rng.randn(b, n, DIM).astype(np.float32),
            "video_padding_mask": np.zeros((b, t), bool),
            "text_padding_mask": np.zeros((b, n), bool),
            "start": start, "end": start + 2}


def jax_trainer(layout: str, model_path: str):
    """The JAX ``TANTrainer`` of ``layout`` with Adam's eps set to ``EPS``."""
    import optax

    from exoground_tpu.models import TemporalAligner
    from exoground_tpu.train.config import ExperimentConfig
    from exoground_tpu.train.trainer import TANTrainer

    cfg = ExperimentConfig(dp_devices=1, model_path=model_path, **CONFIG, **LAYOUTS[layout])
    real = optax.adamw
    optax.adamw = functools.partial(real, eps=EPS)  # the chain's Adam
    try:
        tr = TANTrainer(TemporalAligner(**MODEL), cfg, batch(SEED),
                        iters_per_epoch=ITERS_PER_EPOCH)
    finally:
        optax.adamw = real
    if hasattr(tr.tx, "eps"):  # the fused optimizer's
        tr.tx.eps = EPS
    return tr


def write(layout: str, path: str, orbax_path: str = None):
    """Train 3 steps of ``layout`` from ``SEED`` and save epoch 0 to
    ``path`` (and, given ``orbax_path``, the same state there with the JAX
    ``save_state_orbax``); returns the JAX trainer, ready to take the next
    step."""
    from exoground_tpu.train.checkpoint import save_state_orbax

    tmp = tempfile.mkdtemp()
    try:
        tr = jax_trainer(layout, tmp)
        tr.train_epoch([batch(SEED + 1 + i) for i in range(3)], 0)
        tr.save_epoch(0)
        shutil.move(os.path.join(tmp, "epoch0.pth.tar"), path)
        if orbax_path is not None:
            save_state_orbax(orbax_path, tr._ckpt_state(0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return tr


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    for name in LAYOUTS:
        write(name, fixture_path(name), orbax_fixture_path(name))
        print(fixture_path(name), os.path.getsize(fixture_path(name)))
        print(orbax_fixture_path(name), sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(orbax_fixture_path(name)) for f in fs))
