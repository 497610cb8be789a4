"""eaqhm_torch.benchmarks on the CPU: option parsing, no silent CPU
fallback, and each config's JSON line against the JAX module's metric name
and keys (read from eaqhm_tpu/benchmarks.py and bench.py with ast, without
running them).  Configs 3 and 6 run on 2 utterances of 0.25 s with
max_adaptations=0 (the keys and the paths, not the numbers, are checked)."""
import ast
import os

import pytest
import torch

from eaqhm_torch import benchmarks

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_KEYS = {"device", "dtype", "kernels", "input"}
BASE_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _jax_emits():
    """{config: (metric, keyword names)} of each _emit call of the JAX
    module's bench_configN (config 3 has two: their union)."""
    with open(os.path.join(ROOT, "eaqhm_tpu", "benchmarks.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("bench_config")):
            continue
        n = int(fn.name[len("bench_config"):])
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "_emit"):
                metric = node.args[0].value
                keys = {k.arg for k in node.keywords}
                old = out.get(n, (metric, set()))
                assert old[0] == metric
                out[n] = (metric, old[1] | keys)
    return out


def _bench_py_keys():
    """The keys of bench.py's JSON line (the dict literal in main)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(fn for fn in tree.body
                if isinstance(fn, ast.FunctionDef) and fn.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Dict) and len(node.keys) > 5:
            return {k.value for k in node.keys}
    raise AssertionError("no JSON line in bench.py")


def test_metric_names_and_keys_match_jax():
    jax = _jax_emits()
    assert sorted(jax) == sorted(benchmarks.METRICS) == [1, 2, 3, 4, 5, 6]
    bench_py = _bench_py_keys() - BASE_KEYS
    for n, (metric, keys) in benchmarks.METRICS.items():
        want = set(jax[n][1]) | (bench_py if n == 1 else set())
        assert metric == jax[n][0], n
        assert set(keys) == want, (n, sorted(set(keys) ^ want))


@pytest.mark.parametrize("argv, want", [
    ([], dict(config=1, repeats=3, device=None, dtype="auto",
              solve_method="auto", chunk=None, n_utts=None, wav=None)),
    (["--config", "4", "--dtype", "float64", "--solve-method", "cholesky",
      "--chunk", "64", "--repeats", "1"],
     dict(config=4, dtype="float64", solve_method="cholesky", chunk=64,
          repeats=1)),
    (["--config", "5", "--n-utts", "1024", "--device", "cpu",
      "--seconds", "0.5"],
     dict(config=5, n_utts=1024, device="cpu", seconds=0.5)),
])
def test_config_parsing(argv, want):
    args = benchmarks.build_parser().parse_args(argv)
    for k, v in want.items():
        assert getattr(args, k) == v, k


@pytest.mark.parametrize("argv", [["--config", "7"],
                                  ["--solve-method", "lu"],
                                  ["--dtype", "float16"]])
def test_config_parsing_rejects(argv):
    with pytest.raises(SystemExit):
        benchmarks.build_parser().parse_args(argv)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.Run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.main(["--config", "4"])


def test_run_overrides_and_input():
    run = benchmarks.Run("cpu", dtype="float64", solve_method="cholesky",
                         chunk=64)
    cfg = benchmarks.stress_config(run)
    assert (cfg.gender, cfg.max_adaptations, cfg.dtype, cfg.solve_method,
            cfg.chunk) == ("male", 10, "float64", "cholesky", 64)
    assert run.dtype_name(cfg) == "float64" and run.device_name() == "cpu"
    fs, s, name = run.recording()
    assert fs == 16000 and s.shape == (63488,)
    assert name == benchmarks.SA19_RESYNTH


def _cpu_run():
    run = benchmarks.Run("cpu")
    run.cfg_kw["max_adaptations"] = 0
    return run


def _check_line(line, n):
    metric, keys = benchmarks.METRICS[n]
    assert line["metric"] == metric
    want = BASE_KEYS | set(keys) | PORT_KEYS
    assert set(line) == want - set(benchmarks._OPTIONAL.get(n, ()))
    assert line["device"] == "cpu" and line["dtype"] == "float64"
    assert line["input"] == benchmarks.SA19_RESYNTH
    k = line["kernels"]
    assert k["chol_solve"]["launches"] == k["chol_subst"]["launches"] == 0
    assert k["chol_solve"]["plain_calls"] > 0
    for name in ("fit_basis", "fit_gram", "track_spline", "track_synth",
                 "track_srer", "swipe_loudness", "swipe_pick"):
        assert k[name]["launches"] == 0 and k[name]["plain_calls"] > 0


def test_config3_sequential_on_cpu(capsys):
    line, detail = benchmarks.bench_config3(_cpu_run(), batch=2, repeats=1,
                                            seconds=0.25)
    _check_line(line, 3)
    assert line["path"] == "sequential_per_utterance"
    assert line["batch"] == 2 and line["n_devices"] == 1
    assert len(detail["final_srer"]) == 2
    assert capsys.readouterr().out.count('"metric"') == 1


def test_config6_streams_on_cpu():
    line, detail = benchmarks.bench_config6(_cpu_run(), n_utts=2, repeats=1,
                                            seconds=0.25)
    _check_line(line, 6)
    assert line["n_devices"] == 1 and line["failed"] == 0
    assert len(detail["result"].done) == 2
    assert list(line["per_device"]) == ["cpu#0"]
