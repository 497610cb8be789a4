"""What the port's stream workers share, under threads: the kernel wrapper's
launch counts and its per-thread capture record, the kernel build's lock,
and the fused loop's graph cache (a pool per geometry).  Each test is
time-bounded and runs more threads than cores with a short switch interval,
so that a lost update or a shared entry would show."""
import sys
import threading
import time

import pytest
import torch

from eaqhm_torch.kernels import build
from eaqhm_torch.models import engine
from eaqhm_torch.ops import chol

N_THREADS = 16


def _hammer(fn, n_threads=N_THREADS):
    """Run fn(i) in n_threads threads at once; every thread must finish."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(n_threads)
        errors = []

        def run(i):
            try:
                start.wait(timeout=30)
                fn(i)
            except Exception as e:  # noqa: BLE001 (reported below)
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        sys.setswitchinterval(old)


def test_kernel_counts_lose_no_update():
    R = torch.eye(3, dtype=torch.complex128)[None].repeat(2, 1, 1)
    b = torch.ones((2, 3), dtype=torch.complex128)
    chol.reset_counts()
    reps = 40
    _hammer(lambda i: [chol.chol_solve(R, b) for _ in range(reps)])
    assert chol.chol_solve.plain_calls == N_THREADS * reps
    chol.reset_counts()


def test_capture_record_is_per_thread():
    """A thread that takes its capture record gets its own launches and
    leaves every other thread's alone."""
    got = {}

    def capture(i):
        chol._captured()["chol_solve"].extend([(i, k) for k in range(i + 1)])
        time.sleep(0.001)
        got[i] = chol.take_captured()

    _hammer(capture)
    for i, rec in got.items():
        assert rec["chol_solve"] == [(i, k) for k in range(i + 1)]
        assert rec["chol_subst"] == []


def test_build_runs_once_per_library(monkeypatch):
    """Threads meeting an unbuilt library wait for one build of it."""
    calls = []

    def fake_build(name, flags):
        calls.append(name)
        time.sleep(0.05)
        return name

    monkeypatch.setattr(build, "_build", fake_build)
    monkeypatch.setattr(build, "_bind",
                        lambda key, path: build._loaded.__setitem__(key,
                                                                    path))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_locks", {})
    names = list(build.KERNELS)
    _hammer(lambda i: build.load(names[i % len(names)]))
    assert sorted(calls) == sorted(names)


def test_graph_cache_gives_each_call_its_own_loop():
    """Two calls of one geometry never hold one loop; returned loops are
    kept up to the cache's bound, the oldest key first out."""
    engine.clear_graph_cache()
    try:
        assert engine._take_loop("g") is None
        a, b = object(), object()
        engine._keep_loop("g", a)
        engine._keep_loop("g", b)
        held = {id(engine._take_loop("g")), id(engine._take_loop("g"))}
        assert held == {id(a), id(b)}
        assert engine._take_loop("g") is None
        for i in range(engine._GRAPH_CACHE_SIZE + 3):
            engine._keep_loop(("k", i), object())
        assert engine._take_loop(("k", 0)) is None
        assert engine._take_loop(("k", engine._GRAPH_CACHE_SIZE + 2))

        pool = [object() for _ in range(4)]
        for p in pool:
            engine._keep_loop("h", p)
        taken = []
        lock = threading.Lock()

        def take(i):
            loop = engine._take_loop("h")
            with lock:
                taken.append(loop)

        _hammer(take)
        got = [t for t in taken if t is not None]
        assert len(got) == len(pool) and len({id(t) for t in got}) == 4
    finally:
        engine.clear_graph_cache()


@pytest.mark.gpu
def test_capture_on_one_thread_while_another_launches():
    """On the card: a thread capturing a graph (thread_local mode) while
    another thread launches the kernel eagerly; both results are right and
    each thread's record holds its own launches only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    B, M = 64, 130
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((B, M, M), dtype=torch.complex128, device="cuda",
                    generator=g)
    R = A @ A.mH / M + torch.eye(M, dtype=torch.complex128, device="cuda")
    rhs = torch.randn((B, M), dtype=torch.complex128, device="cuda",
                      generator=g)
    ref = chol.chol_solve_reference(R, rhs)
    chol.library(R.device)
    out = {}

    def capture(_):
        s = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        chol.take_captured()
        with torch.cuda.graph(graph, stream=s,
                              capture_error_mode="thread_local"):
            x = chol.chol_solve(R, rhs)
        out["rec"] = chol.take_captured()
        graph.replay()
        torch.cuda.synchronize()
        out["graph"] = x.clone()

    def eager(_):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for _ in range(20):
                out["eager"] = chol.chol_solve(R, rhs)
        s.synchronize()

    _hammer(lambda i: (capture if i == 0 else eager)(i), n_threads=2)
    assert out["rec"]["chol_solve"] == [(B, M, "resident", "nan", False)]
    for k in ("graph", "eager"):
        assert ((out[k] - ref).abs().max() / ref.abs().max()).item() < 1e-10
