"""Package rules of the PyTorch port and its serving front.

* The port (exoground_tpu_torch/ and chip_smoke.py) imports neither JAX,
  Flax, optax, msgpack, orbax, TensorStore, zstandard nor anything of the
  JAX package.
* Entry points default to the card and raise when CUDA is missing.
* The coalescing front serves every request once, in fewer batches under
  concurrency, surfaces errors to every waiter and zips results strictly.
"""

import ast
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.serve import AlignmentService, _CoalescingFront

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "exoground_tpu", "orbax",
             "tensorstore", "zstandard")


def _port_files():
    return sorted((ROOT / "exoground_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [(p.relative_to(ROOT), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the entry points would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TemporalAligner(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4)
    tm = TemporalAligner(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4,
                         input_dim=16, max_pos=64, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedAlignEvaluator(tm, AlignEvalConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        AlignmentService(tm)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card, and
    alone in a directory without the rest of the repo."""
    import subprocess

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def _front(calls, delay=0.0, results=None):
    def serve(payloads, mode):
        calls.append((len(payloads), mode))
        time.sleep(delay)
        return results(payloads) if results else [(p, mode) for p in payloads]

    return _CoalescingFront(serve)


def test_front_serves_a_solitary_request_at_once():
    calls = []
    front = _front(calls)
    assert front.submit("a", mode_key=1) == ("a", 1)
    assert calls == [(1, 1)]


def test_front_coalesces_concurrent_requests():
    """More threads than cores, a short switch interval: every request is
    answered once, with its own result, in fewer batches than requests."""
    calls = []
    front = _front(calls, delay=0.02)
    n = 32
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = front.submit(i, mode_key=i % 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == [(i, i % 2) for i in range(n)]
    assert sum(c[0] for c in calls) == n
    assert len(calls) < n
    assert all(size <= 16 for size, _ in calls)


def test_front_error_reaches_every_waiter_and_frees_the_front():
    calls = []

    def boom(payloads):
        raise KeyError("device lost")

    front = _front(calls, delay=0.02, results=boom)
    errors = []

    def worker(i):
        try:
            front.submit(i)
        except KeyError as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(errors) == 6
    ok = _CoalescingFront(lambda p, m: list(p))
    assert ok.submit(7) == 7


def test_front_zips_results_strictly():
    front = _CoalescingFront(lambda payloads, mode: [])  # lost a result
    with pytest.raises(ValueError):
        front.submit(np.zeros(3))


def test_service_coalesces_concurrent_align_calls():
    """Concurrent align() calls on the CPU path equal serial ones and reach
    the evaluator in fewer predict() batches."""
    from exoground_tpu_torch.evals.bench_items import make_item
    from exoground_tpu_torch.serve import AlignRequest

    tm = TemporalAligner(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4,
                         input_dim=16, max_pos=64, device="cpu")
    svc = AlignmentService(tm, seq_len=16, device="cpu")
    its = [make_item(s, 40 + 5 * s, 16, 16) for s in range(6)]
    reqs = [AlignRequest(video=it["video"], text_embeds=it["text_embed"]) for it in its]
    serial = [svc.align(r) for r in reqs]
    calls = []
    inner = svc._evaluator.predict

    def counting(batch, all_texts_active=None):
        calls.append(len(batch))
        time.sleep(0.05)
        return inner(batch, all_texts_active=all_texts_active)

    svc._evaluator.predict = counting
    out = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def worker(i):
        barrier.wait()
        out[i] = svc.align(reqs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(out, serial):
        assert got["best_second"] == want["best_second"]
        np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5)
    assert sum(calls) == len(reqs) and len(calls) < len(reqs)
