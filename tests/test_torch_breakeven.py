"""The port's break-even model (``repro_torch.core.breakeven``) against the
JAX package's (``repro.core.breakeven``), in process on the CPU.

Eq. 3, ``BreakEven``'s properties, ``codec_fits`` and ``size_fits`` on
seeded inputs must give identical results.  ``measure_arms`` and
``measure`` are driven by the same fake ``time.perf_counter`` sequence in
both modules, with arms that record their calls: the estimates (the
minimum of the burst means), the round-robin call order and the number of
calls must be equal.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import breakeven as jbe
from repro_torch.core import breakeven as tbe

SEEDS = range(6)


def _times(rng, n):
    """Per-epoch seconds: tens of microseconds to tens of milliseconds."""
    return (10.0 ** rng.uniform(-5, -2, n)).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_n_breakeven_matches_jax(seed):
    """Eq. 3 on seeded (t_init, t_mpi, t_persist) triples, including no
    gain (``math.inf``), a tie and a zero INIT cost (1 epoch)."""
    rng = np.random.default_rng(seed)
    t_init, t_mpi, t_persist = (_times(rng, 40) for _ in range(3))
    cases = list(zip(t_init, t_mpi, t_persist))
    cases += [(0.0, 2e-3, 1e-3), (1e-3, 1e-3, 1e-3), (5e-3, 1e-3, 2e-3)]
    for a, b, c in cases:
        got, want = tbe.n_breakeven(a, b, c), jbe.n_breakeven(a, b, c)
        assert got == want and type(got) is type(want), (a, b, c)
    assert tbe.n_breakeven(1e-3, 1e-3, 2e-3) == math.inf
    assert tbe.n_breakeven(0.0, 2e-3, 1e-3) == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_breakeven_properties_match_jax(seed):
    rng = np.random.default_rng(seed)
    t_init, t_persist, t_mpi = _times(rng, 3)
    t_mpi = 0.0 if seed == 0 else t_mpi        # savings_pct's zero guard
    n = tbe.n_breakeven(t_init, t_mpi, t_persist)
    got = tbe.BreakEven(t_init, t_persist, t_mpi, n)
    want = jbe.BreakEven(t_init, t_persist, t_mpi, n)
    assert got.delta == want.delta
    assert got.savings_pct == want.savings_pct
    for k in (0, 1, 7, 1000):
        assert got.total_persistent(k) == want.total_persistent(k)
        assert got.total_baseline(k) == want.total_baseline(k)


@pytest.mark.parametrize("seed", SEEDS)
def test_codec_fits_match_jax(seed):
    """Per-codec Eq. 3 against the best identity arm: a codec that saves
    gets an epoch count, one that does not (or a sweep without an identity
    arm) gets None."""
    rng = np.random.default_rng(seed)
    names = ["identity", "bf16", "int8", "fp8"]
    best = dict(zip(names, _times(rng, 4)))
    if seed == 1:
        del best["identity"]
    sweep = float(rng.uniform(0.01, 2.0))
    assert tbe.codec_fits(best, sweep) == jbe.codec_fits(best, sweep)


@pytest.mark.parametrize("seed", SEEDS)
def test_size_fits_match_jax(seed):
    """The linear transport fit per codec and the crossover payload against
    identity (None where the codec's per-KiB rate is no better)."""
    rng = np.random.default_rng(seed)
    sizes = [1.0, 4.0, 32.0, 256.0, 1024.0]
    per_codec = {c: {s: float(a + b * s) for s in sizes}
                 for c, a, b in zip(("identity", "bf16", "int8"),
                                    rng.uniform(1e-5, 1e-4, 3),
                                    rng.uniform(1e-7, 1e-6, 3))}
    assert tbe.size_fits(per_codec) == jbe.size_fits(per_codec)


class _FakeClock:
    """A seeded, increasing ``perf_counter``."""

    def __init__(self, seed):
        self._steps = iter(np.random.default_rng(seed).uniform(1e-5, 1e-3,
                                                               10_000))
        self.now = 100.0

    def __call__(self):
        self.now += float(next(self._steps))
        return self.now


def _arms(log, make):
    """Named arms that log each call and return ``make()``."""
    def arm(name):
        def fn():
            log.append(name)
            return make()
        return fn
    return {name: arm(name) for name in ("fence", "lock", "ragged")}


@pytest.mark.parametrize("iters,warmup,bursts", [(12, 2, 3), (50, 5, 4),
                                                 (3, 0, 5)])
def test_measure_arms_matches_jax_on_one_clock(monkeypatch, iters, warmup,
                                               bursts):
    """The estimator itself is kept exactly: warmup, round-robin bursts and
    the minimum of the burst means give equal results on one clock."""
    results, logs = [], []
    for mod, make in ((jbe, lambda: np.zeros(2)),
                      (tbe, lambda: torch.zeros(2))):
        monkeypatch.setattr("time.perf_counter", _FakeClock(7))
        log = []
        results.append(mod.measure_arms(_arms(log, make), iters=iters,
                                        warmup=warmup, bursts=bursts))
        logs.append(log)
    assert results[0] == results[1]
    assert logs[0] == logs[1]
    per_burst = max(iters // bursts, 1)
    assert len(logs[1]) == 3 * (warmup + bursts * per_burst)


def test_measure_matches_jax_on_one_clock(monkeypatch):
    got = []
    for mod, make in ((jbe, lambda: np.zeros(2)),
                      (tbe, lambda: torch.zeros(2))):
        monkeypatch.setattr("time.perf_counter", _FakeClock(3))
        log = []
        arms = _arms(log, make)
        got.append(mod.measure(arms["fence"], arms["lock"], t_init=0.25,
                               iters=20, warmup=3, bursts=4))
    fields = ("t_init", "t_persist", "t_mpi", "n_breakeven")
    assert [getattr(got[1], f) for f in fields] == [getattr(got[0], f)
                                                    for f in fields]
    assert got[1].n_breakeven == tbe.n_breakeven(0.25, got[1].t_mpi,
                                                 got[1].t_persist)


def test_block_waits_only_for_cuda_tensors(monkeypatch):
    """``_block`` (the port's ``block_until_ready``) synchronises the device
    of a CUDA tensor and nothing for a CPU tensor or ``None``."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    for out in (torch.zeros(1), None):
        tbe._block(out)
    assert synced == []


def test_example_runs_on_the_cpu():
    """``examples/persistent_alltoallv_torch.py --device cpu``: every plan,
    the auto plan and the baseline validated, one break-even line per
    variant."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run([sys.executable, os.path.join(
        root, "examples", "persistent_alltoallv_torch.py"), "--device", "cpu",
        "--iters", "4"], capture_output=True, text=True, timeout=300, env=env,
        cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("validated element-wise") == 5
    assert r.stdout.count("N_breakeven=") == 3
