"""Frozen MIL-NCE word2vec text tower + tokenizer.

Counterpart of ``exoground_tpu/models/word2vec.py`` (reference
model/word2vec_model.py:26-102): regex word split, dict lookup over the
``s3d_dict.npy`` vocabulary, pad/truncate to ``max_words``; then
embed -> fc1 -> ReLU -> masked max-pool -> fc2.

The tokenizer is host-side numpy (it runs in the data loader's threads), a
copy of the JAX package's. The tower is a function over a dictionary of
tensors keyed as the MIL-NCE checkpoint's ``text_module`` (``word_embd.weight``,
``fc1.weight``, ``fc1.bias``, ``fc2.weight``, ``fc2.bias``; torch Linear
layout), which ``utils/convert.py::convert_word2vec_from_s3d`` extracts.

The tower computes only ``pooler_output`` unless asked for
``last_hidden_state`` (fc2 over every token): under JAX's jit that unused
output is dropped, while PyTorch would compute it eagerly (at B64 x 32
sentences x 32 tokens, 65,536 rows x 2048 x 512, ~137 GFLOP a step).
``fc1`` still runs over every token: the max-pool needs it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from exoground_tpu_torch.utils.device import resolve_device

_WORD_RE = re.compile(r"[\w']+")
TOWER_KEYS = ("word_embd.weight", "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")


class Word2VecTokenizer:
    """Word-level tokenizer over a word -> token id dict (reference :26-73).
    Token id 0 is the OOV/pad id."""

    def __init__(self, vocab: Dict[str, int], max_words: int = 32):
        self.word_to_token = vocab
        self.token_to_word = {v: k for k, v in vocab.items()}
        self.max_words = max_words

    @classmethod
    def from_dict_file(cls, dict_path: str, max_words: int = 32) -> "Word2VecTokenizer":
        """Load the MIL-NCE ``s3d_dict.npy`` token -> word array; ids start at
        1 (reference s3d_milnce/s3dg.py:198-205)."""
        words = np.load(dict_path)
        vocab = {str(w): i + 1 for i, w in enumerate(words)}
        return cls(vocab, max_words)

    def _split(self, sentence: str) -> List[str]:
        return _WORD_RE.findall(str(sentence).lower())

    def _words_to_ids(self, words: Sequence[str]) -> List[int]:
        ids = [self.word_to_token.get(w, 0) for w in words[: self.max_words]]
        ids.extend([0] * (self.max_words - len(ids)))
        return ids

    def tokenize(self, inputs: Union[str, List[str]]):
        """sentence -> [word, ...]; [sentence, ...] -> [[word, ...], ...]."""
        if isinstance(inputs, str):
            return self._split(inputs)
        return [self._split(s) for s in inputs]

    def __call__(self, inputs: Union[str, List[str]], padding: bool = True,
                 **_) -> Dict[str, np.ndarray]:
        """Batched (B, max_words) int32 ids and mask; a str is a batch of one."""
        if not padding:
            raise ValueError("only padded tokenization is supported")
        if isinstance(inputs, str):
            inputs = [inputs]
        ids = np.asarray([self._words_to_ids(self._split(s)) for s in inputs], dtype=np.int32)
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}


def word2vec_forward(params: Dict[str, torch.Tensor], input_ids: torch.Tensor,
                     attention_mask: torch.Tensor = None,
                     last_hidden: bool = False) -> Dict[str, torch.Tensor]:
    """The frozen tower (reference model/word2vec_model.py:84-102).

    input_ids (B, L) int; attention_mask (B, L), nonzero = keep. Returns
    pooler_output (B, D) and, with ``last_hidden``, last_hidden_state
    (B, L, D): fc2 over every token, which the step and the evals never read."""
    x = F.embedding(input_ids, params["word_embd.weight"])
    x = torch.relu(F.linear(x, params["fc1.weight"], params["fc1.bias"]))
    if attention_mask is not None:
        # all-stop-word sentences keep every position (reference :95)
        keep = attention_mask.bool()
        keep = keep | ~keep.any(dim=-1, keepdim=True)
        pooled = x.masked_fill(~keep[:, :, None], -6e4).amax(dim=1)
    else:
        pooled = x.amax(dim=1)
    out = {"pooler_output": F.linear(pooled, params["fc2.weight"], params["fc2.bias"])}
    if last_hidden:
        out["last_hidden_state"] = F.linear(x, params["fc2.weight"], params["fc2.bias"])
    return out


class Word2VecModel:
    """Frozen tower weights on a device with an HF-like call signature."""

    def __init__(self, params: Dict[str, torch.Tensor], device="cuda"):
        dev = resolve_device(device)
        self.params = {k: torch.as_tensor(params[k]).to(device=dev, dtype=torch.float32)
                       for k in TOWER_KEYS}
        self.device = dev

    @property
    def vocab_rows(self) -> int:
        return int(self.params["word_embd.weight"].shape[0])

    @property
    def out_dim(self) -> int:
        return int(self.params["fc2.weight"].shape[0])

    @torch.no_grad()
    def __call__(self, input_ids, attention_mask=None, last_hidden: bool = False, **_):
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = None if attention_mask is None else torch.as_tensor(attention_mask,
                                                                   device=self.device)
        return word2vec_forward(self.params, ids, mask, last_hidden=last_hidden)
