"""The port's word2vec text tower and tokenizer against the JAX package.

Same seeded numpy inputs through ``exoground_tpu/models/word2vec.py`` and
``exoground_tpu_torch/models/word2vec.py``. Tolerances: token ids equal;
the tower in float32 within 1e-6 of max|JAX| (summation order of fc1/fc2
only); the golden ``word2vec.npz`` within 2e-5 relative (the JAX package's
own golden bar); the default, pooled-only output equal to the
``last_hidden=True`` call's ``pooler_output`` bit for bit (the same
operations).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer
from exoground_tpu.models.word2vec import word2vec_forward as jax_forward
from exoground_tpu.utils.convert import convert_word2vec_from_s3d as jax_convert
from exoground_tpu_torch.models.word2vec import (
    TOWER_KEYS,
    Word2VecModel,
    Word2VecTokenizer,
    word2vec_forward,
)
from exoground_tpu_torch.utils.convert import convert_word2vec_from_s3d, load_torch_checkpoint
from tests import golden_common as G

VOCAB = {w: i + 1 for i, w in enumerate(
    "add the flour mix well stir pour water slice bread don't wait now done".split())}
SENTENCES = {
    "plain": "Add the flour, mix well.",
    "stop_words": "zzz qqq the xxx",
    "all_stop_words": "zzz qqq xxx",
    "empty": "",
    "over_long": " ".join(["stir"] * 40 + ["done"]),
    "apostrophe": "Don't WAIT now!!",
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(SENTENCES))
@pytest.mark.parametrize("max_words", [8, 32])
def test_tokenizer_ids_equal_jax(name, max_words):
    ours = Word2VecTokenizer(dict(VOCAB), max_words=max_words)
    theirs = JaxTokenizer(dict(VOCAB), max_words=max_words)
    for inputs in (SENTENCES[name], [SENTENCES[name], SENTENCES["plain"]]):
        a, b = ours(inputs), theirs(inputs)
        assert a["input_ids"].dtype == np.int32
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    assert ours.tokenize(SENTENCES[name]) == theirs.tokenize(SENTENCES[name])


def test_tokenizer_from_dict_file(tmp_path):
    words = np.array(["alpha", "beta", "gamma"])
    np.save(tmp_path / "d.npy", words)
    ours = Word2VecTokenizer.from_dict_file(str(tmp_path / "d.npy"), max_words=4)
    theirs = JaxTokenizer.from_dict_file(str(tmp_path / "d.npy"), max_words=4)
    assert ours.word_to_token == theirs.word_to_token == {"alpha": 1, "beta": 2, "gamma": 3}
    np.testing.assert_array_equal(ours("Gamma beta delta")["input_ids"],
                                  theirs("Gamma beta delta")["input_ids"])


def _tower_state(seed, vocab=41, emb=24, hid=48, out=32, prefix="text_module."):
    r = np.random.RandomState(seed)
    return {f"{prefix}word_embd.weight": r.randn(vocab, emb).astype(np.float32),
            f"{prefix}fc1.weight": (r.randn(hid, emb) * emb ** -0.5).astype(np.float32),
            f"{prefix}fc1.bias": (r.randn(hid) * 0.1).astype(np.float32),
            f"{prefix}fc2.weight": (r.randn(out, hid) * hid ** -0.5).astype(np.float32),
            f"{prefix}fc2.bias": (r.randn(out) * 0.1).astype(np.float32)}


def _ids(seed, b=6, l=9, vocab=41):
    r = np.random.RandomState(seed)
    ids = r.randint(0, vocab, (b, l)).astype(np.int32)
    ids[1, :] = 0  # an all-stop-word sentence: every position is kept
    ids[2, 3:] = 0
    return ids


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("prefix", ["text_module.", ""])
def test_tower_matches_jax(masked, prefix):
    state = _tower_state(0, prefix=prefix)
    params = convert_word2vec_from_s3d({k: torch.from_numpy(v) for k, v in state.items()})
    assert set(params) == set(TOWER_KEYS)
    jparams = jax_convert(state)
    ids = _ids(1)
    mask = (ids != 0).astype(np.int32) if masked else None
    want = jax_forward(jparams, jnp.asarray(ids), None if mask is None else jnp.asarray(mask))
    got = word2vec_forward(params, torch.from_numpy(ids),
                           None if mask is None else torch.from_numpy(mask), last_hidden=True)
    for key in ("pooler_output", "last_hidden_state"):
        assert got[key].dtype == torch.float32
        assert _rel(got[key].numpy(), want[key]) <= 1e-6, key


def test_pooled_only_equals_pooler_output():
    params = convert_word2vec_from_s3d(_tower_state(2))
    ids = torch.from_numpy(_ids(3))
    full = word2vec_forward(params, ids, ids != 0, last_hidden=True)
    pooled = word2vec_forward(params, ids, ids != 0)
    assert set(pooled) == {"pooler_output"}
    assert torch.equal(pooled["pooler_output"], full["pooler_output"])
    model = Word2VecModel(params, device="cpu")
    assert model.vocab_rows == 41 and model.out_dim == 32
    assert torch.equal(model(ids.numpy(), (ids != 0).numpy())["pooler_output"],
                       full["pooler_output"])


def test_golden_word2vec():
    """The golden fixture: tower outputs (the all-stop-word row fires) and
    tokenizer ids, as tests/test_golden.py holds the JAX package to them."""
    z = np.load(os.path.join(G.GOLDEN_DIR, "word2vec.npz"))
    state = G.synth_state(G.manifest_from_npz(z), seed=17)
    params = convert_word2vec_from_s3d(state)
    ids, mask = G.word2vec_inputs()
    out = word2vec_forward(params, torch.from_numpy(ids), torch.from_numpy(mask), last_hidden=True)
    for key in ("last_hidden_state", "pooler_output"):
        assert _rel(out[key].numpy(), z[f"out::{key}"]) < 2e-5, key
    tok = Word2VecTokenizer(dict(G.GOLDEN_VOCAB), max_words=G.GOLDEN_MAX_WORDS)
    enc = tok(list(G.GOLDEN_SENTENCES))
    np.testing.assert_array_equal(enc["input_ids"], z["out::tok_input_ids"])
    np.testing.assert_array_equal(enc["attention_mask"], z["out::tok_attention_mask"])


def test_load_torch_checkpoint_reads_the_state_dict(tmp_path):
    state = {k: torch.from_numpy(v) for k, v in _tower_state(4).items()}
    torch.save({"state_dict": state, "epoch": 3}, tmp_path / "s3d.pth")
    loaded = load_torch_checkpoint(str(tmp_path / "s3d.pth"))
    assert set(loaded) == set(state)
    params = convert_word2vec_from_s3d(loaded)
    jparams = jax_convert({k: v.numpy() for k, v in state.items()})
    np.testing.assert_array_equal(params["fc1.weight"].numpy(), jparams["fc1"]["kernel"].T)
    np.testing.assert_array_equal(params["word_embd.weight"].numpy(), jparams["word_embd"])


def test_bf16_tower_keeps_the_masked_max():
    """The -6e4 fill stays below every bf16 activation after the ReLU."""
    params = {k: v.to(torch.bfloat16) for k, v in convert_word2vec_from_s3d(_tower_state(5)).items()}
    ids = torch.from_numpy(_ids(6))
    out = word2vec_forward(params, ids, ids != 0)["pooler_output"]
    ref = word2vec_forward(convert_word2vec_from_s3d(_tower_state(5)), ids, ids != 0)[
        "pooler_output"]
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), ref.numpy()) <= 2e-2
