"""The port's epoch telemetry and observability layer against the JAX
package's, in process on the CPU.

``core._exec_stats`` (``EpochRing``, ``ExecTelemetry``) and ``obs`` (spans,
Chrome-trace export and validation, Prometheus text, break-even residuals)
are plain Python and numpy in both packages: fed the same samples,
snapshots and traces, the port's must give equal windows, summaries,
traces, verdicts and text.  Then the port's own sites: a traced plan on
``VirtualMesh(..., device="cpu")`` (INIT, bake, compile, epochs, an auto
sweep), the CLI (``python -m repro_torch.obs``), ``MetricsServer`` on
port 0, and a reduced OLMoE serve with ``--trace``.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import _exec_stats as jexec
from repro.obs import breakeven_check as jcheck
from repro.obs import metrics as jmetrics
from repro.obs import trace_export as jtrace
from repro_torch.core import PlanCache, alltoallv_init
from repro_torch.core import _exec_stats as texec
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.obs import TRACER
from repro_torch.obs import __main__ as tcli
from repro_torch.obs import breakeven_check as tcheck
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace_export as ttrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tracer():
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.reset()


@pytest.mark.parametrize("capacity,n", [(8, 5), (8, 8), (8, 21), (3, 100)])
def test_epoch_ring_matches_jax(capacity, n):
    """Windows (clamped to the retained history), ``last`` and summaries of
    the same samples."""
    samples = np.random.default_rng(capacity * n).uniform(1e-5, 1e-2, n)
    got, want = texec.EpochRing(capacity), jexec.EpochRing(capacity)
    for s in samples:
        got.record(s)
        want.record(s)
    assert got.count == want.count == n
    for a, b in [(0, n), (n - 3, n), (-5, 2), (n - capacity, n + 4), (4, 2),
                 (n - 1, n)]:
        np.testing.assert_array_equal(got.window(a, b), want.window(a, b))
    for k in (1, 3, capacity, 2 * capacity):
        np.testing.assert_array_equal(got.last(k), want.last(k))
    assert got.summary() == want.summary()
    assert texec.EpochRing(4).summary() == {"count": 0}


def _fill(tel, seed=0):
    """The same epochs, rank epochs and fits into one registry."""
    rng = np.random.default_rng(seed)
    for d in ("aa", "bb", "cc"):
        for s in rng.uniform(1e-4, 1e-3, 12):
            tel.record(d, s)
    for r in range(4):
        for s in rng.uniform(1e-4, 1e-3, 5):
            tel.record_rank("aa", r, s)
    tel.record_fit("aa", {"sweep_seconds": 0.02, "t_best": 4e-4,
                          "t_second": 6e-4, "n_amortize": 100})
    tel.record_fit("bb", {"sweep_seconds": 0.02, "t_best": 9e-4,
                          "t_second": 9e-4, "n_amortize": None})
    return tel


def test_exec_telemetry_matches_jax():
    got, want = _fill(texec.ExecTelemetry()), _fill(jexec.ExecTelemetry())
    gs, ws = got.snapshot(), want.snapshot()
    for k in ("plans", "ranks", "fits", "swaps"):
        assert gs[k] == ws[k], k
    assert got.rank_summary("aa") == want.rank_summary("aa")
    assert got.reset_rank_rings("aa") == want.reset_rank_rings("aa") == 4
    ev = got.record_swap(old="aa", new="bb", reason={"kind": "test"})
    assert set(ev) == set(want.record_swap(old="aa", new="bb",
                                           reason={"kind": "test"}))
    got.reset()
    assert got.snapshot() == {"plans": {}, "ranks": {}, "swaps": [],
                              "fits": {}}


def _snapshot():
    """A tracer snapshot: nested init spans, epochs, an instant."""
    recs = [("plan_init", "init", "X", 0.000, 0.010, 11,
             {"warm": False, "digest": "aa"}),
            ("index_table_bake", "init.bake", "X", 0.001, 0.004, 11, {"p": 8}),
            ("plan_compile", "init", "X", 0.020, 0.003, 11, {}),
            ("epoch", "execute", "X", 0.030, 0.0005, 11, {"digest": "aa"}),
            ("epoch", "execute", "X", 0.031, 0.0005, 12, {"digest": "bb"}),
            ("swap", "runtime", "i", 0.040, 0.0, 11, {"new": "bb"})]
    return {"records": recs, "thread_names": {11: "MainThread", 12: "w"},
            "origin_unix": 1.7e9}


def test_chrome_trace_matches_jax(tmp_path):
    snap = _snapshot()
    assert ttrace.chrome_trace(snap) == jtrace.chrome_trace(snap)
    got, want = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    assert ttrace.write_jsonl(str(got), snap) == jtrace.write_jsonl(
        str(want), snap) == len(snap["records"])
    assert got.read_text() == want.read_text()
    trace = ttrace.write_trace(str(tmp_path / "t.json"), snap)
    assert json.loads((tmp_path / "t.json").read_text()) == trace


def _events(*spans, warm=None):
    """Chrome events: (name, cat, ts_us, dur_us[, tid])."""
    evs = []
    for name, cat, ts, dur, *tid in spans:
        args = {"warm": warm} if cat == "init" and warm is not None else {}
        evs.append({"name": name, "cat": cat, "ph": "X", "pid": 1,
                    "tid": tid[0] if tid else 1, "ts": ts, "dur": dur,
                    "args": args})
    return {"traceEvents": evs}


TRACES = {
    "nested": _events(("plan_init", "init", 0, 100),
                      ("index_table_bake", "init.bake", 10, 20),
                      ("epoch", "execute", 200, 10), warm=False),
    "partial_overlap": _events(("plan_init", "init", 0, 100),
                               ("index_table_bake", "init.bake", 50, 100)),
    "other_thread_overlap": _events(("plan_init", "init", 0, 100),
                                    ("epoch", "execute", 50, 100, 2)),
    "warm_with_bake": _events(("plan_init", "init", 0, 100),
                              ("index_table_bake", "init.bake", 10, 20),
                              warm=True),
    "warm_clean": _events(("plan_init", "init", 0, 100),
                          ("plan_compile", "init", 10, 20), warm=True),
    "negative_dur": _events(("epoch", "execute", 0, -1)),
    "no_traceEvents": {"events": []},
    "unknown_phase": {"traceEvents": [{"name": "x", "ph": "B", "ts": 0,
                                       "pid": 1, "tid": 1}]},
    "missing_ts": {"traceEvents": [{"name": "x", "ph": "X", "pid": 1,
                                    "tid": 1, "dur": 1}]},
}


def _verdict(mod, trace, expect=()):
    try:
        return ("ok", mod.validate_trace(trace, expect_cats=expect))
    except mod.TraceValidationError as e:
        return ("invalid", str(e))


@pytest.mark.parametrize("name", sorted(TRACES))
def test_validate_trace_matches_jax(name):
    """Verdicts and summaries on nested, partially overlapping and malformed
    traces, and the warm-INIT rule (no bake child inside a warm init)."""
    got = _verdict(ttrace, TRACES[name])
    assert got == _verdict(jtrace, TRACES[name])
    want_ok = name in ("nested", "other_thread_overlap", "warm_clean")
    assert (got[0] == "ok") == want_ok, got


def test_validate_trace_files_and_expected_categories(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert _verdict(ttrace, str(bad))[0] == "invalid"
    assert _verdict(ttrace, str(bad)) == _verdict(jtrace, str(bad))
    good = tmp_path / "good.json"
    good.write_text(json.dumps(TRACES["nested"]))
    for expect in (("init", "execute"), ("init", "runtime")):
        assert _verdict(ttrace, str(good), expect) == _verdict(
            jtrace, str(good), expect)


def _init_snapshot(seed=0):
    rng = np.random.default_rng(seed)
    keys = ("cold_inits", "warm_inits", "table_bakes", "autotune_sweeps",
            "autotune_bursts", "store_hits", "store_misses", "store_puts",
            "store_invalid")
    return {k: int(v) for k, v in zip(keys, rng.integers(0, 50, len(keys)))}


def test_render_metrics_matches_jax():
    """The exposition text from equal registries, including the
    break-even residual and n_amortize gauges and the per-rank gauge."""
    from repro_torch.core import INIT_STATS
    init = _init_snapshot()
    assert set(init) == set(INIT_STATS.as_dict())
    snap_t = _fill(texec.ExecTelemetry()).snapshot()
    snap_j = _fill(jexec.ExecTelemetry()).snapshot()
    got = tmetrics.render_metrics(snap_t, init)
    assert got == jmetrics.render_metrics(snap_j, init)
    assert 'repro_breakeven_residual{digest="aa"}' in got
    assert 'repro_breakeven_n_amortize{digest="aa"} 100' in got
    empty = {"plans": {}, "ranks": {}, "swaps": [], "fits": {}}
    assert tmetrics.render_metrics(empty, init) == jmetrics.render_metrics(
        empty, init)


@pytest.mark.parametrize("warmup", [0, 3, 12])
def test_check_breakeven_matches_jax(warmup):
    snap_t = _fill(texec.ExecTelemetry(), seed=4).snapshot()
    snap_j = _fill(jexec.ExecTelemetry(), seed=4).snapshot()
    got = tcheck.check_breakeven(snap_t, warmup=warmup)
    assert got == jcheck.check_breakeven(snap_j, warmup=warmup)
    assert len(got) == (2 if warmup < 12 else 0)
    for fit, p50 in (({"t_best": 4e-4}, 5e-4), ({"t_best": 0}, 1e-3), ({}, 1)):
        assert tcheck.breakeven_residual(fit, p50) == \
            jcheck.breakeven_residual(fit, p50)


def test_traced_plan_emits_the_jax_spans(tracer, tmp_path):
    """A traced INIT, compile, epochs and an auto sweep on the CPU: the
    trace validates with init, init.bake, init.autotune and execute spans;
    sweep bursts record no epochs; whole epochs recorded through
    ``record_epoch`` feed the auto plan's break-even residual."""
    counts = np.random.default_rng(0).integers(0, 6, (4, 4))
    mesh = VirtualMesh((4,), ("x",), device="cpu")
    plan = alltoallv_init(counts, (4,), torch.float32, mesh, variant="fence",
                          pack_impl="fused", cache=PlanCache())
    x = torch.zeros(plan.global_send_shape)
    before = plan.epoch_ring.count
    for _ in range(5):
        plan.wait(plan.start(x))
    assert plan.epoch_ring.count == before + 5
    cache = PlanCache()
    auto = alltoallv_init(counts, (4,), torch.float32, mesh, variant="auto",
                          pack_impl="fused", cache=cache)
    assert auto.record_starts and auto.epoch_ring.count == 0
    auto.record_starts = False
    for _ in range(5):
        t0 = time.perf_counter()
        auto.wait(auto.start(x))
        auto.record_epoch(time.perf_counter() - t0)
    assert auto.epoch_ring.count == 5
    path = tmp_path / "trace.json"
    ttrace.write_trace(str(path))
    summary = ttrace.validate_trace(
        str(path), expect_cats=("init", "init.bake", "init.autotune",
                                "execute"))
    names = {ev["name"] for ev in json.loads(path.read_text())["traceEvents"]}
    assert {"plan_init", "index_table_bake", "plan_compile", "epoch",
            "measure_bursts", "autotune_sweep"} <= names
    assert summary["cold_inits"] == 1 + len(auto.auto_choice["times"])
    line = f'repro_breakeven_residual{{digest="{auto.signature.digest}"}}'
    assert line in tmetrics.render_metrics()


def test_cli_trace_and_metrics(tmp_path, capsys):
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps(TRACES["nested"]))
    bad.write_text(json.dumps(TRACES["warm_with_bake"]))
    assert tcli.main(["trace", str(good), "--validate", "--expect",
                      "init"]) == 0
    assert "TRACE OK" in capsys.readouterr().out
    assert tcli.main(["trace", str(bad), "--validate"]) == 1
    assert "TRACE INVALID" in capsys.readouterr().err
    assert tcli.main(["trace", str(good), "--expect", "runtime"]) == 1
    assert tcli.main(["report", "--trace", str(good), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["init"]["spans"] == 1
    out = tmp_path / "m" / "metrics.prom"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs", "metrics",
                        "--out", str(out)], capture_output=True, text=True,
                       timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "repro_init_total{kind=\"cold\"} 0" in out.read_text()
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs", "trace",
                        str(bad), "--validate"], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 1 and "warm-start contract" in r.stderr


def test_metrics_server_on_port_0():
    server = tmetrics.MetricsServer(0).start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.status == 200
        assert "# TYPE repro_autotune_sweeps_total counter" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/other", timeout=10)
        assert e.value.code == 404
    finally:
        server.stop()


def test_reduced_serve_writes_a_valid_trace(tmp_path):
    """Reduced OLMoE on EP 8 virtual ranks, ``--trace`` and
    ``--metrics-file``: the trace validates with the INIT spans of the MoE
    dispatch plans and one ``prefill`` and one ``decode`` execute span."""
    trace, metrics = tmp_path / "serve.json", tmp_path / "serve.prom"
    tserve.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--mesh", "1,8", "--batch", "2", "--prompt-len", "8",
                 "--tokens", "3", "--trace", str(trace),
                 "--metrics-file", str(metrics)])
    assert not TRACER.enabled
    summary = ttrace.validate_trace(str(trace),
                                    expect_cats=("init", "execute"))
    execute = [ev["name"] for ev in json.loads(trace.read_text())["traceEvents"]
               if ev.get("cat") == "execute"]
    assert sorted(execute) == ["decode", "prefill"]
    assert summary["cold_inits"] >= 1
    assert "repro_init_total" in metrics.read_text()
