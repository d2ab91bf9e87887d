"""The word2vec test vocabulary, tower weights and sentences shared by the
raw-text tests (``tests/test_torch_serve_http.py`` and
``tests/test_torch_retrieval.py``); a test module imports them by name."""

import numpy as np

VOCAB_WORDS, TEXT_DIM = 199, 32
VOCAB = {f"w{i}": i for i in range(1, VOCAB_WORDS + 1)}


def tower_state(seed=0, emb=16, hid=48):
    """Seeded weights of the S3D text module (``text_module.*``), ``TEXT_DIM``
    outputs."""
    r = np.random.RandomState(seed)
    return {"text_module.word_embd.weight": r.randn(VOCAB_WORDS + 1, emb).astype(np.float32),
            "text_module.fc1.weight": (r.randn(hid, emb) * emb ** -0.5).astype(np.float32),
            "text_module.fc1.bias": (r.randn(hid) * 0.1).astype(np.float32),
            "text_module.fc2.weight": (r.randn(TEXT_DIM, hid) * hid ** -0.5).astype(np.float32),
            "text_module.fc2.bias": (r.randn(TEXT_DIM) * 0.1).astype(np.float32)}


def sentences(seed, k):
    """k sentences of 'w<id>' words with out-of-vocabulary words among them;
    sentence 1 has only unknown words (every position pooled), sentence 2 is
    empty."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(k):
        words = [f"w{j}" if r.rand() > 0.2 else f"zz{j}"
                 for j in r.randint(1, VOCAB_WORDS + 1, r.randint(3, 12))]
        out.append(" ".join(words))
    out[1] = "zzz qqq xxx"
    out[2] = ""
    return out
