"""Serving layer: the TAN alignment service on the card.

Counterpart of ``exoground_tpu/serve.py`` for the alignment path:

  * ``AlignmentService`` — holds a port ``TemporalAligner`` and the fused
    evaluator (parameters cast once, kernels built at first use); a request
    is one video plus candidate text embeddings, the response per-text best
    seconds and confidence scores.
  * ``_CoalescingFront`` — concurrent ``align()`` calls coalesce into one
    batched ``predict`` (the evaluator packs up to ``group_videos`` videos
    per device pass).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from exoground_tpu_torch.evals.align import AlignEvalConfig
from exoground_tpu_torch.evals.align_fused import FusedAlignEvaluator
from exoground_tpu_torch.models.aligner import TemporalAligner
from exoground_tpu_torch.utils.convert import load_reference_state


class _CoalescingFront:
    """Natural batching for concurrent single-request traffic.

    The first requester to find no batch in flight becomes the leader and
    serves the queue at once (a solitary request waits for nothing).
    Requests that arrive while a batch is in flight queue up and wait on a
    condition variable; the leader drains the queue in FIFO batches (up to
    ``MAX_BATCH``, one ``mode_key`` per batch) until its own request is
    served, wakes the waiters after every batch, and hands leadership on.
    """

    MAX_BATCH = 16

    def __init__(self, serve_batch):
        self._serve_batch = serve_batch  # (payloads, mode_key) -> results
        self._cv = threading.Condition()
        self._queue: List[tuple] = []
        self._leading = False

    def submit(self, payload, mode_key=None):
        slot: Dict = {}
        with self._cv:
            self._queue.append((payload, mode_key, slot))
            while self._leading and "done" not in slot:
                self._cv.wait()
            lead = "done" not in slot
            if lead:
                self._leading = True
        if lead:
            try:
                while "done" not in slot:
                    self._drain_once()
            finally:
                with self._cv:
                    self._leading = False
                    self._cv.notify_all()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _drain_once(self):
        with self._cv:
            mode = self._queue[0][1]  # FIFO: serve the head's protocol mode
            # partition by identity, never list.remove(): payloads hold numpy
            # arrays whose == is elementwise
            batch, rest = [], []
            for e in self._queue:
                if e[1] == mode and len(batch) < self.MAX_BATCH:
                    batch.append(e)
                else:
                    rest.append(e)
            self._queue = rest
        try:
            results = self._serve_batch([e[0] for e in batch], mode)
            for e, r in zip(batch, results, strict=True):
                e[2]["result"] = r
        except Exception as ex:  # surface to every waiter, never deadlock
            for e in batch:
                e[2]["error"] = ex
        with self._cv:
            for e in batch:
                e[2]["done"] = True
            self._cv.notify_all()


@dataclass
class AlignRequest:
    video: np.ndarray  # (T, Dv) per-second features
    text_embeds: np.ndarray  # (K, Dt)
    # optional per-text coarse timestamps: enable the overlap-seq active-text
    # protocol; otherwise all texts are active in every window
    start: Optional[np.ndarray] = None
    end: Optional[np.ndarray] = None


class AlignmentService:
    """TAN alignment inference (overlap-seq protocol, device-resident)."""

    def __init__(self, model: TemporalAligner, seq_len: int = 64,
                 transfer_dtype: str = "float16", use_alignability_head: bool = False,
                 device="cuda"):
        self.model = model
        self.cfg = AlignEvalConfig(
            seq_len=seq_len, transfer_dtype=transfer_dtype, group_videos=8,
            use_alignability_head=use_alignability_head,
        )
        # ONE evaluator serves both protocols: all_texts_active is a per-call
        # host-side switch
        self._evaluator = FusedAlignEvaluator(model, self.cfg, device=device)
        self._lock = threading.Lock()
        self._front = _CoalescingFront(self._predict_batch)

    def _predict_batch(self, items, all_texts_active):
        with self._lock:
            return self._evaluator.predict(items, all_texts_active=all_texts_active)

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, num_layers: int = 6,
                        device="cuda", **kw):
        """Serve the reference's released .pth.tar (cotrain TAN): its state
        dict loads as it is, the EMA target branch of a cotrain checkpoint.
        The model carries the binary head when the checkpoint does; the
        head-score protocol still needs ``use_alignability_head=True``."""
        state = load_reference_state(checkpoint_path)
        model = TemporalAligner(
            num_encoder_layers=num_layers, num_joint_layers=num_layers,
            use_alignability_head=int("binary_head.weight" in state), device="cpu",
        )
        model.load_state_dict(state, strict=True)
        return cls(model, device=device, **kw)

    def align(self, req: AlignRequest) -> Dict:
        """One video + K texts -> per-text best second + confidence score."""
        te = np.asarray(req.text_embeds, np.float32)
        k = te.shape[0]
        vlen = req.video.shape[0]
        if (req.start is None) != (req.end is None):
            raise ValueError(
                "AlignRequest needs BOTH start and end (coarse per-text "
                "timestamps) or neither (score all texts in all windows)")
        all_texts = req.start is None
        if all_texts:
            start = np.zeros(k)
            end = np.full(k, float(vlen))
            order = np.arange(k)
        else:
            start = np.asarray(req.start, np.float64)
            end = np.asarray(req.end, np.float64)
            # the active-text protocol derives index spans, which assumes
            # chronological text order: sort by midpoint, unsort the results
            order = np.argsort((start + end) / 2.0, kind="stable")
            start, end, te = start[order], end[order], te[order]
        item = {
            "video": np.asarray(req.video, np.float32),
            "start": start, "end": end,
            "aligned": np.zeros(k, np.int64),
            "text_embed": te,
        }
        out = self._front.submit(item, all_texts)
        inv = np.empty(k, np.int64)
        inv[order] = np.arange(k)
        return {
            "best_second": out["argmax"][inv].tolist(),
            "score": out["score"][inv].tolist(),
            "align_score": out["align_score"][inv].tolist(),
        }
