"""Serving layer: the TAN alignment and keystep grounding services on the
card.

Counterpart of ``exoground_tpu/serve.py`` for these paths:

  * ``AlignmentService`` — holds a port ``TemporalAligner`` and the fused
    evaluator (parameters cast once, kernels built at first use); a request
    is one video plus candidate text embeddings, the response per-text best
    seconds and confidence scores. Over a resident corpus it also ranks
    checkpoints (``score_checkpoints``) and answers q request batches at
    once (``align_batch_requests``, ``align_query_batches``).
  * ``GroundingService`` — holds a port ``ExoGroundingTransformer`` or
    ``GroundingModel``; a request is one video window plus narration
    embeddings, the response per-narration (start, end) in [0, 1] of the
    window. Requests are bucketed by padded narration count, one forward
    per bucket. ``from_checkpoint`` serves the port's own checkpoint files
    and the JAX package's (flax msgpack, read without ``msgpack`` or
    ``flax``).
  * ``_CoalescingFront`` — concurrent ``align()`` / ``ground()`` calls
    coalesce into one batched call (the evaluator packs up to
    ``group_videos`` videos per device pass; a grounding bucket is one
    forward).
  * ``serve_http`` — a stdlib HTTP/1.1 front (POST /align, /align_batch,
    /ground, /ground_batch with npz-encoded arrays, JSON answers), the JAX
    package's wire format.

Alignment requests carry either text embeddings (precomputed upstream) or
raw texts, which a service built with a tokenizer and the word2vec tower
(``models/word2vec.py``) embeds itself.
"""

from __future__ import annotations

import io
import json
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from exoground_tpu_torch.evals.align import AlignEvalConfig
from exoground_tpu_torch.evals.align_fused import FusedAlignEvaluator
from exoground_tpu_torch.models.aligner import TemporalAligner
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.utils.convert import load_reference_state
from exoground_tpu_torch.utils.device import resolve_device
from exoground_tpu_torch.utils.shapes import round_up


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
    texts: Optional[List[str]] = None  # raw sentences (a tokenizer and tower attached)
    text_embeds: Optional[np.ndarray] = None  # (K, Dt)
    # optional per-text coarse timestamps: enable the overlap-seq active-text
    # protocol; otherwise all texts are active in every window
    start: Optional[np.ndarray] = None
    end: Optional[np.ndarray] = None


class AlignmentService:
    """TAN alignment inference (overlap-seq protocol, device-resident)."""

    def __init__(self, model: TemporalAligner, tokenizer=None, text_tower=None,
                 seq_len: int = 64, transfer_dtype: str = "float16",
                 matmul_dtype: str = "default", use_alignability_head: bool = False,
                 device="cuda", eval_devices: int = 1):
        self.model = model
        # raw texts: tokenizer(texts) -> ids and pad mask, text_tower(ids,
        # attention_mask=) -> {'pooler_output': (K, Dt)} on the service's device
        self.tokenizer = tokenizer
        self.text_tower = text_tower
        # matmul_dtype='int8' serves through the int8 projections
        # (ops/quant.py) with the JAX service's policy: int8_min_cols stays
        # 0, so every projection is quantized on the unfused path and the
        # fused int8 kernels, which need 3C or 4C >= min_cols > C, stay off
        # eval_devices > 1 round-robins video groups over that many cards
        # (clamped to the cards present; single align() requests ride the
        # first)
        self.cfg = AlignEvalConfig(
            seq_len=seq_len, transfer_dtype=transfer_dtype, group_videos=8,
            use_alignability_head=use_alignability_head, matmul_dtype=matmul_dtype,
            eval_devices=eval_devices,
        )
        # ONE evaluator serves both protocols: all_texts_active is a per-call
        # host-side switch
        self._evaluator = FusedAlignEvaluator(model, self.cfg, device=device)
        tower_dev = getattr(text_tower, "device", None)
        if tower_dev is not None and _device_key(tower_dev) != _device_key(self._evaluator.device):
            raise ValueError(f"the text tower is on {tower_dev} but the service on "
                             f"{self._evaluator.device}; build both on one device")
        self._pp_evaluator: Optional[FusedAlignEvaluator] = None
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
        head-score protocol still needs ``use_alignability_head=True``.
        ``kw`` (``tokenizer``, ``text_tower``, ...) goes to the service."""
        state = load_reference_state(checkpoint_path)
        # the input widths come from the checkpoint, as the JAX Dense layers
        # take theirs from the params (a 512-d word2vec text side, say)
        model = TemporalAligner(
            num_encoder_layers=num_layers, num_joint_layers=num_layers,
            use_alignability_head=int("binary_head.weight" in state),
            video_dim=state["video_pre_proj.weight"].shape[1],
            text_dim=state["text_pre_proj.weight"].shape[1], device="cpu",
        )
        model.load_state_dict(state, strict=True)
        return cls(model, device=device, **kw)

    def _embed_texts(self, texts: List[str]) -> np.ndarray:
        """Raw sentences -> (K, Dt) float32 host embeddings: the tokenizer's
        ids and pad mask through the tower (the mask must reach it: the
        max-pool would otherwise pool over pad embeddings, unlike the
        embeddings the model was trained on), its ``pooler_output`` read
        back from the device."""
        if self.tokenizer is None or self.text_tower is None:
            raise ValueError("attach tokenizer + text_tower to serve raw texts")
        tok = self.tokenizer(texts)
        ids = np.asarray(tok["input_ids"])
        mask = np.asarray(tok.get("attention_mask", (ids != 0).astype(np.int32)))
        out = self.text_tower(ids, attention_mask=mask)["pooler_output"]
        return torch.as_tensor(out).float().cpu().numpy()

    def _text_embeds(self, text_embeds, texts) -> np.ndarray:
        if text_embeds is not None:
            return np.asarray(text_embeds, np.float32)
        return self._embed_texts(texts)

    def align(self, req: AlignRequest) -> Dict:
        """One video + K texts (raw or embedded) -> per-text best second +
        confidence score."""
        if (req.start is None) != (req.end is None):
            raise ValueError(
                "AlignRequest needs BOTH start and end (coarse per-text "
                "timestamps) or neither (score all texts in all windows)")
        te = self._text_embeds(req.text_embeds, req.texts)
        item, order = _request_item(req.video, te, req.start, req.end)
        return _answer(self._front.submit(item, req.start is None), order)

    # ------------------------------------------------------------------
    # resident serving (the evaluator's preload paths)
    # ------------------------------------------------------------------

    def score_checkpoints(self, items: Sequence[Dict], state_dicts: Sequence,
                          resident=None) -> List[Dict[str, float]]:
        """Rank k checkpoints (state dicts of the served model) against one
        labelled corpus (``evals/align.py``'s item schema), one packed result
        a group for all of them (``FusedAlignEvaluator.run_many``); one
        {'Recall', 'AUC'} dict per checkpoint. Pass
        ``resident=preload_corpus(items)`` to reuse an upload across calls."""
        with self._lock:
            pre = resident or self._evaluator.preload(items)
            return self._evaluator.run_many(pre, list(state_dicts))

    def preload_corpus(self, items: Sequence[Dict]):
        """Upload a scoring corpus to the device once (see ``score_checkpoints``)."""
        with self._lock:
            return self._evaluator.preload(items)

    def _preproject_evaluator(self) -> FusedAlignEvaluator:
        """A twin evaluator under ``cfg.preproject``, built at first use, for
        the resident query paths; ``align()`` keeps the streaming one."""
        if self._pp_evaluator is None:
            self._pp_evaluator = FusedAlignEvaluator(
                self.model, replace(self.cfg, preproject=True),
                device=self._evaluator.device)
        return self._pp_evaluator

    def align_batch_requests(self, videos: Sequence[np.ndarray],
                             text_batches: Sequence[Sequence[Dict]],
                             preproject: bool = False) -> List[List[Dict]]:
        """q request batches over one corpus of V videos -> one
        ``align()``-shaped answer per (batch, video), every batch scored over
        the resident corpus (``align_query_batches``).

        ``text_batches[i]`` has V entries in the order of ``videos``, each
        {'text_embeds' (K, Dt) or 'texts' (raw, through the tower), optional
        'start'/'end' coarse per-text timestamps}. Timestamp presence must be
        the same across the whole call (else ``ValueError``): with timestamps
        the active-text protocol runs (texts sorted by midpoint per video and
        unsorted in the answer, as ``align()`` does); without, every text
        scores in every window."""
        has_ts = None
        item_batches, orders = [], []
        for batch in text_batches:
            if len(batch) != len(videos):
                raise ValueError(f"each batch needs one entry per corpus video "
                                 f"({len(batch)} != {len(videos)})")
            items, border = [], []
            for video, req in zip(videos, batch):
                te = self._text_embeds(req.get("text_embeds"), req.get("texts"))
                ts = req.get("start") is not None
                if ts != (req.get("end") is not None):
                    raise ValueError("a request needs BOTH start and end (coarse per-text "
                                     "timestamps) or neither")
                if has_ts is None:
                    has_ts = ts
                elif ts != has_ts:
                    raise ValueError("timestamp presence must be the same across an "
                                     "align_batch_requests call (the active-text "
                                     "protocol is a per-call mode)")
                item, order = _request_item(video, te, req.get("start"), req.get("end"))
                items.append(item)
                border.append(order)
            item_batches.append(items)
            orders.append(border)
        preds = self.align_query_batches(item_batches, preproject=preproject,
                                         all_texts_active=not has_ts)
        return [[_answer(p, order) for p, order in zip(batch_preds, border)]
                for batch_preds, border in zip(preds, orders)]

    def align_query_batches(self, query_batches: Sequence[Sequence[Dict]],
                            preproject: bool = False,
                            all_texts_active: Optional[bool] = None) -> List[List[Dict]]:
        """q batches of items (``evals/align.py``'s schema) over ONE video
        corpus -> one ``predict``-shaped result list per batch
        (``FusedAlignEvaluator.preload_queries`` / ``predict_queries``): the
        corpus is uploaded once and every batch is scored over it. Entry i
        equals ``predict(query_batches[i])`` but for one edge: a video none
        of whose texts activates a window reports align_score 0 where
        ``predict`` reports NEG_FILL ('score' carries the sentinel on both).
        ``preproject=True`` goes through a twin evaluator under
        ``cfg.preproject``: the corpus's input stages run once, at preload."""
        with self._lock:
            ev = self._preproject_evaluator() if preproject else self._evaluator
            pq = ev.preload_queries(query_batches, all_texts_active)
            return ev.predict_queries(pq)


def _device_key(device) -> tuple:
    """(type, index) of a device, a bare 'cuda' read as the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return ("cuda", torch.cuda.current_device())
    return (dev.type, dev.index)


def _request_item(video, te, start, end):
    """One request as an evaluator item and the order its texts were put in.
    With timestamps the active-text protocol derives index spans, which
    assumes chronological text order: the texts are sorted by midpoint (and
    ``_answer`` unsorts them); without, every text spans the whole video."""
    k, vlen = te.shape[0], video.shape[0]
    if start is None:
        start, end, order = np.zeros(k), np.full(k, float(vlen)), np.arange(k)
    else:
        start, end = np.asarray(start, np.float64), np.asarray(end, np.float64)
        order = np.argsort((start + end) / 2.0, kind="stable")
        start, end, te = start[order], end[order], te[order]
    item = {"video": np.asarray(video, np.float32), "start": start, "end": end,
            "aligned": np.zeros(k, np.int64), "text_embed": te}
    return item, order


def _answer(pred: Dict, order: np.ndarray) -> Dict:
    """An evaluator prediction as an ``align()`` answer, in request order."""
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    return {
        "best_second": pred["argmax"][inv].tolist(),
        "score": pred["score"][inv].tolist(),
        "align_score": pred["align_score"][inv].tolist(),
    }


class GroundingService:
    """ExoGround interval prediction (the JAX ``GroundingService``,
    serve.py:396-531): every video pads to ``seq_len`` frames and every
    narration set to a multiple of ``text_bucket``, so the attention windows
    of a served forward are ``seq_len``, ``text_bucket`` and their sum. The
    model is moved to ``device`` once and served in eval mode."""

    def __init__(self, model, seq_len: int = 64, text_bucket: int = 64,
                 matmul_dtype: str = "default", device="cuda"):
        # same serving knob as AlignmentService: 'int8' quantizes the
        # pre-projections and the block products (ops/quant.py, the JAX
        # service's policy: int8_min_cols 0); the head stays exact
        if matmul_dtype not in quant.VALID_IMPLS:
            raise ValueError(f"matmul_dtype must be one of {quant.VALID_IMPLS}, "
                             f"got {matmul_dtype!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.seq_len = seq_len
        self.text_bucket = text_bucket
        self.matmul_dtype = matmul_dtype
        self._lock = threading.Lock()
        # concurrent ground() calls coalesce into bucket-batched forwards
        self._front = _CoalescingFront(
            lambda reqs, ucd: self.ground_batch(reqs, use_center_duration=ucd))

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, model=None, device="cuda", **kw):
        """Serve a grounding checkpoint file into ``model``, by default a
        ``GroundingModel`` without a view-invariant pre-pass at the fields of
        the JAX default ``ExoGroundingTransformer()``; a caller whose file
        holds a pre-pass passes a model with one. The file's ``state_dict``
        (a port file's as ``EgoExoTrainer.save_epoch`` writes it; a JAX
        package file's, the JAX ``from_checkpoint``, serve.py:440-446,
        through ``grounding_state_dict_from_jax``) must fit the model
        (``load_checked``: a missing, unexpected or misshapen key raises,
        naming it)."""
        from exoground_tpu_torch.models.grounding import GroundingModel
        from exoground_tpu_torch.train.checkpoint import checkpoint_format, load_state
        from exoground_tpu_torch.utils.convert import grounding_state_dict_from_jax, load_checked

        state = load_state(checkpoint_path)["state_dict"]
        if checkpoint_format(checkpoint_path) != "torch":
            state = grounding_state_dict_from_jax(state)
        model = model if model is not None else GroundingModel(vi_encoder_type="none",
                                                               device="cpu")
        load_checked(model, state)
        return cls(model, device=device, **kw)

    def _run(self, host: np.ndarray, b: int, kpad: int, dv: int, dt: int) -> np.ndarray:
        """One forward of a bucket from its packed float32 host buffer
        (``_pack``): one upload, the model, one download."""
        buf = torch.from_numpy(host).to(self.device)
        video, narr, vmask, nmask = torch.split(
            buf, [b * self.seq_len * dv, b * kpad * dt, b * self.seq_len, b * kpad])
        dtype = next(self.model.parameters()).dtype
        with torch.no_grad(), quant.matmul_impl(self.matmul_dtype):
            preds = self.model(video.view(b, self.seq_len, dv).to(dtype),
                               narr.view(b, kpad, dt).to(dtype),
                               vmask.view(b, self.seq_len) > 0, nmask.view(b, kpad) > 0,
                               deterministic=True)["interval_preds"]
        # use_decoder=False models emit per-stage (B, Stage, N, 2)
        # predictions; serve the final stage (grounding.py:236)
        if preds.dim() == 4:
            preds = preds[:, -1]
        return preds.float().cpu().numpy()

    def _pack(self, requests, idxs, kpad: int):
        """The bucket's videos and narrations zero-padded to (B, seq_len, Dv)
        and (B, kpad, Dt), then the two padding masks (1.0 at PAD), in one
        flat float32 buffer."""
        b = len(idxs)
        dv = requests[idxs[0]]["video"].shape[1]
        dt = requests[idxs[0]]["narration_embeds"].shape[1]
        sizes = np.cumsum([b * self.seq_len * dv, b * kpad * dt, b * self.seq_len])
        host = np.zeros(sizes[-1] + b * kpad, np.float32)
        vb, nb, vmask, nmask = np.split(host, sizes)
        vb, nb = vb.reshape(b, self.seq_len, dv), nb.reshape(b, kpad, dt)
        vmask, nmask = vmask.reshape(b, self.seq_len), nmask.reshape(b, kpad)
        vmask[:], nmask[:] = 1.0, 1.0
        for row, i in enumerate(idxs):
            video, narr = requests[i]["video"], requests[i]["narration_embeds"]
            vb[row, :video.shape[0]] = video
            nb[row, :narr.shape[0]] = narr
            vmask[row, :video.shape[0]] = 0.0
            nmask[row, :narr.shape[0]] = 0.0
        return host, dv, dt

    def ground(self, video: np.ndarray, narration_embeds: np.ndarray,
               use_center_duration: bool = True) -> Dict:
        """(T, Dv) window features + (K, Dt) narrations -> per-narration
        normalized (start, end). A video longer than ``seq_len`` is
        rejected: the intervals would refer to a truncated window."""
        t = video.shape[0]
        if t > self.seq_len:
            raise ValueError(f"video has {t} frames but the grounding model's window is "
                             f"{self.seq_len}; split the video into windows upstream")
        return self._front.submit({"video": video, "narration_embeds": narration_embeds},
                                  use_center_duration)

    def ground_batch(self, requests: Sequence[Dict],
                     use_center_duration: bool = True) -> List[Dict]:
        """Requests ({'video' (T, Dv), 'narration_embeds' (K, Dt)}) grouped
        by padded narration bucket, each bucket one forward; results in
        request order, entry i equal to ``ground()`` on request i (batch
        rows are independent)."""
        buckets: Dict[int, List[int]] = {}
        for i, req in enumerate(requests):
            t = req["video"].shape[0]
            if t > self.seq_len:
                raise ValueError(f"request {i}: video has {t} frames but the grounding "
                                 f"model's window is {self.seq_len}; split upstream")
            kpad = round_up(req["narration_embeds"].shape[0], self.text_bucket)
            buckets.setdefault(kpad, []).append(i)
        results: List[Optional[Dict]] = [None] * len(requests)
        with self._lock:
            for kpad, idxs in buckets.items():
                host, dv, dt = self._pack(requests, idxs, kpad)
                preds = self._run(host, len(idxs), kpad, dv, dt)
                for row, i in enumerate(idxs):
                    p = preds[row, :requests[i]["narration_embeds"].shape[0]]
                    if use_center_duration:
                        s, e = p[:, 0] - p[:, 1] / 2, p[:, 0] + p[:, 1] / 2
                    else:
                        s, e = p[:, 0], p[:, 1]
                    results[i] = {"start": s.tolist(), "end": e.tolist()}
        return results


def _encode_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    """The wire format: a compressed npz of named arrays (the JAX package's)."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _decode_npz(blob: bytes) -> Dict[str, np.ndarray]:
    return dict(np.load(io.BytesIO(blob), allow_pickle=False))


def serve_http(align_service: Optional[AlignmentService] = None,
               ground_service: Optional[GroundingService] = None,
               host: str = "0.0.0.0", port: int = 8571, block: bool = True):
    """A stdlib HTTP/1.1 front (the JAX ``serve_http``, serve.py:544-667).

    POST /align  body: npz {video (T, Dv), text_embed (K, Dt)[, start, end]}
    POST /align_batch body: npz {video_{j} (Tj, Dv) for j in 0..V-1,
        text_embed_{i}_{j} (Kij, Dt) for batch i / video j
        [, start_{i}_{j}, end_{i}_{j}]}: q request batches over one video
        corpus (``AlignmentService.align_batch_requests``); answer
        {"batches": [[per-video {best_second, score, align_score}]]}
    POST /ground body: npz {video (T, Dv), narration (K, Dt)}
    POST /ground_batch body: npz {video_{i} (Ti, Dv), narration_{i} (Ki, Dt)}:
        n grounding requests (``GroundingService.ground_batch``); answer
        {"requests": [...]}.
    Answers are JSON with a Content-Length (connections stay open between
    requests); a chunked body gets 411 and the connection closes; an
    unknown route 404 after its body is read; an empty batch 400; any error
    500 with its text. Each connection is served on a thread of its own.
    With ``block=False`` the server runs on a daemon thread and is returned
    (``shutdown()`` then ``server_close()``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            # only Content-Length bodies are framed here: an unread chunked
            # stream would be parsed as the next request on the open socket
            if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                self.close_connection = True
                self._reply(411, {"error": "chunked bodies unsupported; send Content-Length"})
                return
            if self.path not in ("/align", "/align_batch", "/ground", "/ground_batch"):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self._reply(404, {"error": f"no handler for {self.path}"})
                return
            try:
                arrays = _decode_npz(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                if self.path == "/align" and align_service is not None:
                    req = AlignRequest(video=arrays["video"], text_embeds=arrays["text_embed"],
                                       start=arrays.get("start"), end=arrays.get("end"))
                    self._reply(200, align_service.align(req))
                elif self.path == "/align_batch" and align_service is not None:
                    videos = []
                    while f"video_{len(videos)}" in arrays:
                        videos.append(arrays[f"video_{len(videos)}"])
                    batches = []
                    while f"text_embed_{len(batches)}_0" in arrays:
                        i = len(batches)
                        batches.append([{"text_embeds": arrays[f"text_embed_{i}_{j}"],
                                         "start": arrays.get(f"start_{i}_{j}"),
                                         "end": arrays.get(f"end_{i}_{j}")}
                                        for j in range(len(videos))])
                    if not videos or not batches:
                        self._reply(400, {"error": "align_batch needs video_{j} and "
                                                   "text_embed_{i}_{j} arrays"})
                        return
                    self._reply(200, {"batches": align_service.align_batch_requests(
                        videos, batches)})
                elif self.path == "/ground" and ground_service is not None:
                    self._reply(200, ground_service.ground(arrays["video"], arrays["narration"]))
                elif self.path == "/ground_batch" and ground_service is not None:
                    reqs = []
                    while f"video_{len(reqs)}" in arrays:
                        i = len(reqs)
                        reqs.append({"video": arrays[f"video_{i}"],
                                     "narration_embeds": arrays[f"narration_{i}"]})
                    if not reqs:
                        self._reply(400, {"error": "ground_batch needs video_{i}/narration_{i} "
                                                   "arrays"})
                        return
                    self._reply(200, {"requests": ground_service.ground_batch(reqs)})
                else:
                    self._reply(404, {"error": f"no handler for {self.path}"})
            except Exception as e:  # surface, don't kill the server
                self._reply(500, {"error": str(e)})

    server = ThreadingHTTPServer((host, port), Handler)
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
