"""Raw-text alignment serving and the HTTP front of the port, against the
JAX package.

The same seeded weights (numpy, through the weight bridge) and inputs go
through the JAX ``AlignmentService(tokenizer=, text_tower=)`` and the
port's: ``best_second`` equal, ``score`` and ``align_score`` within 1e-5
(float32 transfer; the two frameworks sum in different orders). Within the
port, raw texts equal the same request sent as the tower's embeddings bit
for bit, and every HTTP answer equals the direct call on the same service
(JSON carries Python floats exactly). The npz wire format decodes to equal
arrays across the two packages, both ways.
"""

import http.client
import json
import socket
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models.word2vec import Word2VecModel as JaxTower
from exoground_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer
from exoground_tpu.serve import AlignmentService as JaxService
from exoground_tpu.serve import AlignRequest as JaxRequest
from exoground_tpu.serve import _decode_npz as jax_decode
from exoground_tpu.serve import _encode_npz as jax_encode
from exoground_tpu.utils.convert import convert_word2vec_from_s3d as jax_convert_tower
from exoground_tpu_torch.models import ExoGroundingTransformer, TemporalAligner
from exoground_tpu_torch.models.word2vec import Word2VecModel, Word2VecTokenizer
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.serve import (
    AlignmentService,
    AlignRequest,
    GroundingService,
    _decode_npz,
    _encode_npz,
    serve_http,
)
from exoground_tpu_torch.utils.convert import convert_word2vec_from_s3d, load_tan_params
from tests.test_torch_small import jax_params
from tests.torch_text_common import TEXT_DIM, VOCAB, sentences, tower_state

VDIM, TDIM = 24, TEXT_DIM
ARCH = dict(num_encoder_layers=1, num_joint_layers=1, width=64, heads=4, max_pos=128,
            random_pos_start=0)
SVC = dict(seq_len=16, transfer_dtype="float32")


def _timestamps(seed, k, vlen):
    r = np.random.RandomState(seed)
    centers = r.rand(k) * (vlen - 6) + 2  # deliberately unsorted
    return np.maximum(centers - 2, 0), np.minimum(centers + 2, vlen)


@pytest.fixture(scope="module")
def services():
    """(port service, JAX service, port model, port tower) on the same
    weights, each with its tokenizer and tower attached."""
    jm = JaxAligner(**ARCH, attn_impl="xla")
    params = jax_params(jm, jnp.zeros((1, 8, VDIM)), jnp.zeros((1, 2, TDIM)),
                        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool), seed=5)
    tm = TemporalAligner(**ARCH, video_dim=VDIM, text_dim=TDIM, device="cpu")
    load_tan_params(tm, params)
    state = tower_state()
    tower = Word2VecModel(convert_word2vec_from_s3d(
        {k: torch.from_numpy(v) for k, v in state.items()}), device="cpu")
    svc = AlignmentService(tm, tokenizer=Word2VecTokenizer(dict(VOCAB)), text_tower=tower,
                           device="cpu", **SVC)
    jsvc = JaxService(jm, {"params": params}, tokenizer=JaxTokenizer(dict(VOCAB)),
                      text_tower=JaxTower(jax_convert_tower(state)), **SVC)
    return svc, jsvc, tm, tower


def _same_answer(got, want, tol=1e-5):
    assert got["best_second"] == want["best_second"]
    for k in ("score", "align_score"):
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol, err_msg=k)


@pytest.mark.parametrize("with_ts", [False, True])
def test_raw_text_align_matches_jax(services, with_ts):
    """align() of raw texts (an all-unknown-word and an empty sentence among
    them) against the JAX service with its tokenizer and tower."""
    svc, jsvc, _, _ = services
    video = np.random.RandomState(1).randn(52, VDIM).astype(np.float32)
    texts = sentences(2, 7)
    start, end = _timestamps(3, 7, 52) if with_ts else (None, None)
    got = svc.align(AlignRequest(video=video, texts=texts, start=start, end=end))
    want = jsvc.align(JaxRequest(video=video, texts=texts, start=start, end=end))
    assert len(got["best_second"]) == 7
    _same_answer(got, want)


def test_raw_texts_equal_their_embeddings(services):
    """Raw texts == the same request as the tower's embeddings, bit for bit;
    the tower gets the pad mask (pooling without it differs)."""
    svc, _, _, tower = services
    video = np.random.RandomState(4).randn(40, VDIM).astype(np.float32)
    texts = sentences(5, 6)
    tok = svc.tokenizer(texts)
    te = tower(tok["input_ids"], attention_mask=tok["attention_mask"])["pooler_output"].numpy()
    np.testing.assert_array_equal(svc._embed_texts(texts), te)
    unmasked = tower(tok["input_ids"])["pooler_output"].numpy()
    assert np.abs(unmasked - te).max() > 1e-3
    start, end = _timestamps(6, 6, 40)
    for kw in ({}, {"start": start, "end": end}):
        assert (svc.align(AlignRequest(video=video, texts=texts, **kw))
                == svc.align(AlignRequest(video=video, text_embeds=te, **kw)))


def test_align_batch_requests_texts_match_jax(services):
    """align_batch_requests with 'texts' entries (and one 'text_embeds'
    entry) against the JAX call, with timestamps and without."""
    svc, jsvc, _, _ = services
    rng = np.random.RandomState(7)
    videos = [rng.randn(v, VDIM).astype(np.float32) for v in (44, 30, 60)]
    for with_ts in (True, False):
        batches = []
        for b in range(2):
            batch = []
            for j, video in enumerate(videos):
                entry = {"texts": sentences(10 * b + j, 5)}
                if with_ts:
                    entry["start"], entry["end"] = _timestamps(b + j, 5, len(video))
                batch.append(entry)
            batches.append(batch)
        batches[1][2] = dict(batches[1][2], texts=None,
                             text_embeds=svc._embed_texts(sentences(99, 5)))
        got = svc.align_batch_requests(videos, batches)
        want = jsvc.align_batch_requests(videos, batches)
        for g_batch, w_batch in zip(got, want, strict=True):
            for g, w in zip(g_batch, w_batch, strict=True):
                _same_answer(g, w)


def test_from_checkpoint_passes_the_tokenizer_and_tower(services, tmp_path):
    """``from_checkpoint`` of a reference-style file (DDP ``module.`` keys,
    width 512, the input widths of the checkpoint: 24-d video, the tower's
    32-d text) hands ``tokenizer`` and ``text_tower`` to the service, which
    answers as a service built on the same model."""
    _, _, _, tower = services
    torch.manual_seed(0)
    tm = TemporalAligner(num_encoder_layers=1, num_joint_layers=1, video_dim=VDIM,
                         text_dim=TDIM, device="cpu")
    path = tmp_path / "tan.pth.tar"
    torch.save({"state_dict": {f"module.{k}": v for k, v in tm.state_dict().items()}}, path)
    tok = Word2VecTokenizer(dict(VOCAB))
    svc = AlignmentService.from_checkpoint(str(path), num_layers=1, tokenizer=tok,
                                           text_tower=tower, device="cpu", **SVC)
    assert svc.tokenizer is tok and svc.text_tower is tower
    direct = AlignmentService(tm, tokenizer=tok, text_tower=tower, device="cpu", **SVC)
    video = np.random.RandomState(8).randn(36, VDIM).astype(np.float32)
    req = AlignRequest(video=video, texts=sentences(9, 4))
    assert svc.align(req) == direct.align(req)


def test_raw_texts_need_a_tower_on_the_service_device(services):
    _, _, tm, tower = services
    bare = AlignmentService(tm, device="cpu", **SVC)
    with pytest.raises(ValueError, match="attach tokenizer"):
        bare.align(AlignRequest(video=np.zeros((20, VDIM), np.float32), texts=["w1"]))
    meta = Word2VecModel(tower.params, device="meta")
    with pytest.raises(ValueError, match="one device"):
        AlignmentService(tm, tokenizer=Word2VecTokenizer(dict(VOCAB)), text_tower=meta,
                         device="cpu", **SVC)


# ------------------------------------------------------------------ HTTP
@pytest.fixture(scope="module")
def ground_service():
    torch.manual_seed(0)
    model = ExoGroundingTransformer(num_encoder_layers=1, num_decoder_layers=1,
                                    video_embed_dim=VDIM, text_embed_dim=TDIM, feature_dim=32,
                                    heads=4, max_pos=64, random_pos_start=0, device="cpu")
    return GroundingService(model, seq_len=16, text_bucket=8, device="cpu")


@pytest.fixture(scope="module")
def server(services, ground_service):
    srv = serve_http(align_service=services[0], ground_service=ground_service,
                     host="127.0.0.1", port=0, block=False)
    yield srv
    srv.shutdown()
    srv.server_close()


def _post(port, path, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_http_front(server, services):
    """Mirror of tests/test_serve.py::test_http_front: /align answers as
    align() does; an unknown route is a 404."""
    port = server.server_address[1]
    rng = np.random.RandomState(0)
    video, te = rng.randn(60, VDIM).astype(np.float32), rng.randn(4, TDIM).astype(np.float32)
    start, end = _timestamps(1, 4, 60)
    for kw in ({}, {"start": start, "end": end}):
        payload = _post(port, "/align", _encode_npz(dict(video=video, text_embed=te, **kw)))
        assert payload == services[0].align(AlignRequest(video=video, text_embeds=te, **kw))
        assert len(payload["best_second"]) == 4
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/nope", b"x", timeout=30)
    assert e.value.code == 404


def test_http_align_batch_endpoint(server, services):
    """Mirror of tests/test_serve.py::test_http_align_batch_endpoint."""
    port = server.server_address[1]
    rng = np.random.RandomState(7)
    videos = [rng.randn(v, VDIM).astype(np.float32) for v in (48, 64)]
    arrays = {f"video_{j}": v for j, v in enumerate(videos)}
    batches = []
    for i in range(2):
        batch = []
        for j, video in enumerate(videos):
            te = rng.randn(4, TDIM).astype(np.float32)
            s, e = _timestamps(10 * i + j, 4, len(video))
            arrays.update({f"text_embed_{i}_{j}": te, f"start_{i}_{j}": s, f"end_{i}_{j}": e})
            batch.append({"text_embeds": te, "start": s, "end": e})
        batches.append(batch)
    payload = _post(port, "/align_batch", _encode_npz(arrays))
    assert payload["batches"] == services[0].align_batch_requests(videos, batches)


def test_http_ground_routes_equal_direct_calls(server, ground_service):
    """/ground and /ground_batch answer as ground() and ground_batch()."""
    port = server.server_address[1]
    rng = np.random.RandomState(3)
    reqs = [{"video": rng.randn(t, VDIM).astype(np.float32),
             "narration_embeds": rng.randn(k, TDIM).astype(np.float32)}
            for t, k in ((16, 3), (9, 5), (12, 11))]
    one = _post(port, "/ground", _encode_npz({"video": reqs[0]["video"],
                                              "narration": reqs[0]["narration_embeds"]}))
    assert one == ground_service.ground(reqs[0]["video"], reqs[0]["narration_embeds"])
    arrays = {}
    for i, r in enumerate(reqs):
        arrays.update({f"video_{i}": r["video"], f"narration_{i}": r["narration_embeds"]})
    payload = _post(port, "/ground_batch", _encode_npz(arrays))
    assert payload["requests"] == ground_service.ground_batch(reqs)


def test_http_keepalive_connection_reuse(server):
    """Mirror of tests/test_serve.py::test_http_keepalive_connection_reuse:
    two requests over one HTTP/1.1 connection, then a 404 on it, which
    keeps it open."""
    rng = np.random.RandomState(7)
    body = _encode_npz({"video": rng.randn(40, VDIM).astype(np.float32),
                        "text_embed": rng.randn(3, TDIM).astype(np.float32)})
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    try:
        outs = []
        for path in ("/align", "/align", "/nope", "/align"):
            conn.request("POST", path, body)
            resp = conn.getresponse()
            assert resp.version == 11  # HTTP/1.1 negotiated
            assert resp.status == (404 if path == "/nope" else 200)
            assert int(resp.getheader("Content-Length")) > 0
            payload = json.loads(resp.read())
            if resp.status == 200:
                outs.append(payload)
        assert outs[0] == outs[1] == outs[2]
    finally:
        conn.close()


def _raw_post(port, path, body, chunked=False):
    """(status, payload, whether the server closed the connection) of one
    POST sent on a raw socket."""
    head = f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
    if chunked:
        head += "Transfer-Encoding: chunked\r\n\r\n"
        data = head.encode() + b"%x\r\n%s\r\n0\r\n\r\n" % (len(body), body)
    else:
        data = head.encode() + f"Content-Length: {len(body)}\r\n\r\n".encode() + body
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(data)
        f = sock.makefile("rb")
        status = int(f.readline().split()[1])
        headers = {}
        for line in iter(f.readline, b"\r\n"):
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        payload = json.loads(f.read(int(headers["content-length"])))
        sock.settimeout(2.0)
        try:
            closed = f.read(1) == b""
        except socket.timeout:
            closed = False
    return status, payload, closed


STATUS_CASES = {
    "chunked": ("/align", 411),
    "unknown_route": ("/nope", 404),
    "empty_align_batch": ("/align_batch", 400),
    "empty_ground_batch": ("/ground_batch", 400),
    "not_npz": ("/align", 500),
}


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_http_error_statuses(server, case):
    """411 and a closed connection for a chunked body; 404 for an unknown
    route, 400 for an empty batch and 500 with the error text for a body
    that is not npz, each keeping the connection open."""
    path, status = STATUS_CASES[case]
    body = b"not an npz body" if case == "not_npz" else _encode_npz(
        {"unrelated": np.zeros(3, np.float32)})
    got, payload, closed = _raw_post(server.server_address[1], path, body,
                                     chunked=case == "chunked")
    assert got == status and payload["error"]
    assert closed == (case == "chunked")


def test_npz_wire_format_matches_jax():
    """Each package decodes the other's bodies to equal arrays."""
    rng = np.random.RandomState(11)
    arrays = {"video": rng.randn(9, VDIM).astype(np.float32),
              "text_embed": rng.randn(3, TDIM).astype(np.float32),
              "start": np.array([0.5, 2.0, 7.25]), "ids": np.arange(4, dtype=np.int64)}
    for encode, decode in ((_encode_npz, jax_decode), (jax_encode, _decode_npz),
                           (_encode_npz, _decode_npz)):
        got = decode(encode(arrays))
        assert set(got) == set(arrays)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
    with pytest.raises(ValueError):
        _decode_npz(_encode_npz({"obj": np.array([{"a": 1}], dtype=object)}))


def test_launch_counts_survive_concurrent_handlers(monkeypatch):
    """The HTTP front runs each connection's work on a thread of its own, so
    every writer of ``LAUNCHES`` (a count, a replay's counts, the reset and a
    capture's snapshot and restore) holds ``_kernels._count_lock``. Then 32
    threads counting 2,000 launches each (a switch interval of 1 us to
    interleave them) lose none; CPython's ``+= 1`` on a dict entry rarely
    loses one even without the lock, so that half pins the API rather than
    reproducing a race."""
    held = []

    class Recording:
        def __init__(self):
            self.lock = threading.Lock()

        def __enter__(self):
            self.lock.acquire()
            held.append(dict(_kernels.LAUNCHES))

        def __exit__(self, *exc):
            self.lock.release()

    with monkeypatch.context() as m:
        m.setattr(_kernels, "_count_lock", Recording())
        _kernels.reset_launches()
        _kernels.count_launch("fused_mha")
        _kernels.add_launches({"fused_mlp": 2})
        assert len(held) == 3
        with _kernels.captured_launches() as counts:
            assert len(held) == 4  # the snapshot
            _kernels.count_launch("small_attn")
        assert len(held) == 6 and counts == {"small_attn": 1}  # the count, the restore
        assert _kernels.LAUNCHES["small_attn"] == 0 and _kernels.LAUNCHES["fused_mlp"] == 2
    interval = sys.getswitchinterval()
    _kernels.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_kernels.count_launch("fused_mha")
                                                    for _ in range(2000)]) for _ in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert _kernels.LAUNCHES["fused_mha"] == 32 * 2000
    _kernels.reset_launches()
