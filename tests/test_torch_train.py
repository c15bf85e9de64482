"""The port's training substrate against the JAX package, in process on
the CPU: schedules, AdamW, the synthetic data and its pipeline, int8
compression, clipping and microbatch accumulation on shared numpy inputs;
the checkpoint format; and the train launcher, twice against one plan
store.

Tolerances: ``lr_at`` rtol 1e-6; ``adamw_update`` (fp32) rtol 1e-6;
batches, int8 codes and checkpoints bit for bit; ``dequantize_int8``,
``clip_by_global_norm`` rtol 1e-6; ``accumulate_grads`` rtol 1e-5 against
JAX and rtol 1e-5, atol 1e-7 between ``n_micro`` 2 and 1 (sums in another
order).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.parallel import compression as jcomp
from repro.train import grad as jgrad
from repro.train import optimizer as jopt
from repro.train import schedule as jsched
from repro_torch._tree import leaves_with_paths
from repro_torch.ckpt import CheckpointManager, put_tree
from repro_torch.configs import get_reduced
from repro_torch.data import DataPipeline, DataConfig, SyntheticTokens
from repro_torch.parallel import compression
from repro_torch.train import grad, optimizer, schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("cosine", "linear", "wsd", "constant")


def tree_np(seed=0, shapes=(("a", (4, 6)), ("b", (7,)))):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes}


def to_t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def to_j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_lr_at_matches_jax(kind):
    kw = dict(kind=kind, peak_lr=3e-4, min_lr_ratio=0.1, warmup_steps=10,
              total_steps=100, decay_steps=20)
    steps = [0, 1, 5, 10, 11, 50, 79, 80, 81, 99, 100, 150]
    got = [float(schedule.lr_at(schedule.ScheduleConfig(**kw), s)) for s in steps]
    want = [float(jsched.lr_at(jsched.ScheduleConfig(**kw), s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("master", [True, False])
def test_adamw_update_matches_jax(master):
    params, g1, g2 = tree_np(0), tree_np(1), tree_np(2)
    cfg_t = optimizer.AdamWConfig(master_weights=master)
    cfg_j = jopt.AdamWConfig(master_weights=master)
    st_t = optimizer.init_opt_state(to_t(params), cfg_t)
    st_j = jopt.init_opt_state(to_j(params), cfg_j)
    assert sorted(st_t) == sorted(st_j)
    p_t, p_j = to_t(params), to_j(params)
    keep = p_t["a"]
    for g, lr in ((g1, 1e-3), (g2, 5e-4)):
        p_t, st_t = optimizer.adamw_update(to_t(g), st_t, p_t,
                                           torch.tensor(lr), cfg_t)
        p_j, st_j = jopt.adamw_update(to_j(g), st_j, p_j, jnp.float32(lr), cfg_j)
    assert p_t["a"] is keep          # updated in place
    for k in params:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=1e-6)
        for part in ("m", "v") + (("master",) if master else ()):
            np.testing.assert_allclose(st_t[part][k].numpy(),
                                       np.asarray(st_j[part][k]), rtol=1e-6)
    assert int(st_t["count"]) == int(st_j["count"]) == 2


def test_synthetic_tokens_and_pipeline_bit_equal_across_restart():
    cfg = get_reduced("olmoe-1b-7b")
    dc = dict(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=7)
    for s in (0, 3, 11):
        np.testing.assert_array_equal(
            SyntheticTokens(DataConfig(**dc)).batch_at(s),
            jsyn.SyntheticTokens(jsyn.DataConfig(**dc)).batch_at(s))
    mine = DataPipeline(cfg, 64, 4, seed=5)
    theirs = jpipe.DataPipeline(cfg, 64, 4, seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(next(mine)["tokens"].numpy(),
                                      np.asarray(next(theirs)["tokens"]))
    state = mine.state_dict()
    assert state == theirs.state_dict() == {"step": 3}
    resumed = DataPipeline(cfg, 64, 4, seed=5)
    resumed.load_state_dict(json.loads(json.dumps(state)))
    np.testing.assert_array_equal(next(resumed)["tokens"].numpy(),
                                  np.asarray(next(theirs)["tokens"]))


def test_quantize_dequantize_int8_match_jax():
    x = np.random.default_rng(3).standard_normal((33, 5)).astype(np.float32)
    q, s = compression.quantize_int8(torch.from_numpy(x))
    qj, sj = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_allclose(float(s), float(sj), rtol=1e-7)
    np.testing.assert_allclose(compression.dequantize_int8(q, s).numpy(),
                               np.asarray(jcomp.dequantize_int8(qj, sj)),
                               rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = tree_np(4)
    out, gn = grad.clip_by_global_norm(to_t(g), max_norm)
    out_j, gn_j = jgrad.clip_by_global_norm(to_j(g), max_norm)
    np.testing.assert_allclose(float(gn), float(gn_j), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-6)


def test_accumulate_grads_two_micro_against_one_and_jax():
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 5)).astype(np.float32),
             "y": rng.standard_normal((8, 3)).astype(np.float32)}

    def loss_t(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        loss = (r * r).mean()
        return loss, {"loss": loss, "l1": r.abs().mean()}

    def loss_j(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        loss = (r * r).mean()
        return loss, {"loss": loss, "l1": jnp.abs(r).mean()}

    one = grad.accumulate_grads(loss_t, to_t(params), to_t(batch), 1)
    two = grad.accumulate_grads(loss_t, to_t(params), to_t(batch), 2)
    two_j = jgrad.accumulate_grads(loss_j, to_j(params), to_j(batch), 2)
    np.testing.assert_allclose(float(two[0]), float(two_j[0]), rtol=1e-5)
    for k in ("loss", "l1"):
        np.testing.assert_allclose(float(two[1][k]), float(two_j[1][k]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(two[1][k]), float(one[1][k]),
                                   rtol=1e-5)
    for k in params:
        assert two[2][k].dtype == torch.float32
        np.testing.assert_allclose(two[2][k].numpy(), np.asarray(two_j[2][k]),
                                   rtol=1e-5)
        np.testing.assert_allclose(two[2][k].numpy(), one[2][k].numpy(),
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip_is_exact(tmp_path, async_save):
    gen = torch.Generator().manual_seed(0)
    trees = {"params": {"a": torch.randn(3, 4, generator=gen).bfloat16(),
                        "b": {"c": torch.randn(5, generator=gen)}},
             "opt": {"m": {"a": torch.randn(3, 4, generator=gen)},
                     "count": torch.tensor(7, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    for step in (0, 3, 6):
        mgr.save(step, trees, extras={"data": {"step": step}, "step": step})
    mgr.wait()
    assert mgr.all_steps() == [3, 6] and mgr.latest_step() == 6
    step, back, extras = mgr.load()
    assert step == 6 and extras == {"data": {"step": 6}, "step": 6}
    flat_in, flat_out = (dict(leaves_with_paths(t)) for t in (trees, back))
    assert sorted(flat_in) == sorted(flat_out)
    for k, v in flat_in.items():
        assert flat_out[k].dtype == v.dtype and torch.equal(flat_out[k], v), k
    live = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": {"c": torch.zeros(5)}}
    keep = live["a"]
    placed = put_tree(back["params"], "cpu", out=live)
    assert placed["a"] is keep and torch.equal(keep, trees["params"]["a"])
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    with open(tmp_path / "step_000000006" / "manifest.json") as f:
        assert json.load(f)["leaves"]["params/a"]["dtype"] == "bfloat16"


def test_ckpt_imports_no_msgpack():
    code = ("import sys, repro_torch.ckpt, repro_torch.train; "
            "assert 'msgpack' not in sys.modules, 'msgpack'; print('OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_train_launcher_twice_against_one_plan_store(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "olmoe-1b-7b", "--reduced", "--device", "cpu", "--mesh", "1,8",
            "--steps", "3", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--plan-store", str(tmp_path / "store")]
    first = subprocess.run(base, capture_output=True, text=True, env=env,
                           timeout=300, cwd=ROOT)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "'final_step': 3" in first.stdout
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() == 3
    _, trees, _ = mgr.load()
    assert int(trees["opt"]["count"]) == 3
    second = subprocess.run(base + ["--assert-warm-init"], capture_output=True,
                            text=True, env=env, timeout=300, cwd=ROOT)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "ASSERT-WARM-INIT OK" in second.stdout
    assert "restored checkpoint at step 3" in second.stderr
    if not torch.cuda.is_available():        # the default --device cuda
        from repro_torch.launch import train as launch_train
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(base[3:6] + base[8:12])


def test_remat_backward_in_another_thread_keeps_the_axis_rules():
    """On a card the backward, and with it the recomputation of each
    checkpointed layer, runs in autograd's device thread, where the
    thread-local axis rules are unset: the layer must carry its own, or
    the recomputed MoE layer takes another dispatch.  Here the backward
    runs in a fresh thread and must give the same gradients."""
    import threading

    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import api as model_api
    from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

    cfg = get_reduced("olmoe-1b-7b", n_layers=2)
    mesh = VirtualMesh((1, 4), ("data", "model"), device="cpu")
    tokens = torch.from_numpy(SyntheticTokens(DataConfig(
        cfg.vocab_size, 32, 4)).batch_at(0))
    with axis_rules(DEFAULT_RULES, mesh):
        plan = model_api.build_moe_plan(cfg, 4 * 31, mesh)
    params, _ = model_api.init_model(cfg, torch.Generator().manual_seed(0))
    leaves = [p.requires_grad_(True) for _, p in leaves_with_paths(params)]

    def loss():
        with axis_rules(DEFAULT_RULES, mesh):
            return model_api.model_loss(params, cfg, {"tokens": tokens},
                                        moe_plan=plan, remat=True)[0]

    here = torch.autograd.grad(loss(), leaves)
    out = {}
    l2 = loss()
    t = threading.Thread(target=lambda: out.update(
        g=torch.autograd.grad(l2, leaves)))
    t.start()
    t.join()
    assert "g" in out
    for a, b in zip(here, out["g"]):
        assert torch.equal(a, b)


def test_trainer_checkpoint_stores_master_once_and_resumes_bit_equal(tmp_path):
    """bf16 params with fp32 master weights: a checkpoint holds the
    optimizer state only (the params are the master's cast), and a fresh
    Trainer resumed from it holds the writer's params and state bit for
    bit, then trains on."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_reduced("olmoe-1b-7b", n_layers=2, param_dtype="bfloat16")
    mesh = VirtualMesh((1, 4), ("data", "model"), device="cpu")
    bundle = steps_mod.make_train_bundle(
        cfg, ShapeConfig("train_4k", "train", 32, 4), mesh)
    assert bundle.meta["adamw"].master_weights

    def trainer(n):
        return Trainer(bundle, TrainerConfig(
            n_steps=n, ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=True))

    first = trainer(2)
    first.init_state()          # state given: no step-0 checkpoint
    first.run()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2]
    _, trees, extras = mgr.load()
    assert sorted(trees) == ["opt"] and extras["step"] == 2
    second = trainer(3)
    assert second.try_resume() and second.start_step == 2
    for (k, a), (_, b) in zip(leaves_with_paths(first.params),
                              leaves_with_paths(second.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), k
    for (k, a), (_, b) in zip(leaves_with_paths(first.opt_state),
                              leaves_with_paths(second.opt_state)):
        assert torch.equal(a, b), k
    out = second.run()
    assert out["final_step"] == 3 and [h["step"] for h in second.history] == [2]
