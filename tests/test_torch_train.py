"""The port's training slice (``repro_torch.optim``, ``training``,
``models.transformer.forward``, ``data``, ``checkpoint``, ``launch.train``)
against the JAX package at the f32 smoke configs: the JAX parameters and
optimizer state go through ``convert.lm_params_from_jax`` and
``adamw_state_from_jax``, and both packages step on the same pipeline
batches.

Tolerances (measured on the CPU before they were pinned; relative errors
are max|port - jax| / max|jax|):
- ``cross_entropy``: float32 within 1e-6 (measured 9.5e-8); bfloat16 logits
  equal (both upcast, then the same float32 sums);
- one AdamW step on shared gradients: parameters and moments equal;
  ``global_norm`` within 1e-6 (the port sums squares in float64; measured
  equal here) and the clipped update equal in float32;
- schedules: constant and linear equal; warmup-cosine equal through the
  warmup, then within 1e-6 of the peak (the two ``cos`` differ by an ulp
  at 33 of 1,100 steps; measured 9.7e-8);
- ``forward`` logits within 1e-4 (measured 3.4e-5) at S 128 (the port's
  flash path, JAX's ``sdpa_ref``) and S 32 (both ``sdpa_ref``);
- three ``make_train_step`` steps, microbatches 1 and 2: loss within 1e-6
  (measured 3.8e-7), grad_norm within 2e-3 (measured 7.9e-4: the float32
  gradients differ by up to 1e-4 of their largest value through the
  attention's softmax, as between the two attention paths of the port),
  every parameter within 2e-2 of its largest value and at most 10 % of its
  elements further apart than 1e-3 of it (measured 8.0e-3 and 4.7 %: Adam
  turns a gradient within rounding of 0 into a full learning-rate step of
  either sign, so a few elements part by up to 2 lr per step);
- ``remat="full"`` against ``"none"`` within the port: equal.
"""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import model_defs as jmodel_defs
from repro.optim import schedule as jschedule
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro.training.losses import cross_entropy as jcross_entropy
from repro_torch import checkpoint as ckpt
from repro_torch import configs, optim
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import forward, init_params, model_defs
from repro_torch.optim import schedule as tschedule
from repro_torch.optim.transform import tree_items
from repro_torch.training import StragglerAbort, TrainConfig, Trainer, \
    TrainerConfig, cross_entropy, make_train_step

ARCHS = ["yi-9b", "codeqwen1.5-7b", "phi4-mini-3.8b"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The smoke models are tiny: one intra-op thread runs them fastest, and
    the suite's parallel workers do not oversubscribe the cores. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_smoke(name):
    jcfg = jconfigs.get_smoke_config(name)
    return jcfg, jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Loss, optimizer, schedules, pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches(dtype, z_loss):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 16, 512)).astype(np.float32) * 3
    labels = rng.integers(0, 512, (2, 16))
    want = float(jcross_entropy(jnp.asarray(logits, getattr(jnp, dtype)),
                                jnp.asarray(labels), z_loss))
    got = float(cross_entropy(torch.tensor(logits).to(getattr(torch, dtype)),
                              torch.tensor(labels), z_loss))
    if dtype == "bfloat16":
        assert got == want
    else:
        assert abs(got - want) <= 1e-6 * abs(want)


def _shared_tree(rng, scale=1.0):
    return {"a": rng.standard_normal((8, 16)).astype(np.float32) * scale,
            "b": {"c": rng.standard_normal((16,)).astype(np.float32) * scale,
                  "d": rng.standard_normal((4, 4, 4)).astype(np.float32)
                  * scale}}


def test_one_adamw_step_on_shared_grads():
    """``global_norm``, the clip, ``adamw``'s update and ``apply_updates``
    on the same float32 parameters, moments and gradients (the moments
    after two earlier steps)."""
    rng = np.random.default_rng(1)
    params, grads = _shared_tree(rng), _shared_tree(rng, 3.0)
    jtx = joptim.adamw(1e-3, weight_decay=0.1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    for scale in (0.5, 2.0):           # two earlier steps fill the moments
        _, jstate = jtx.update(jax.tree_util.tree_map(
            lambda g: jnp.asarray(g * scale), grads), jstate, jparams)
    tparams = lm_params_from_jax(params, device="cpu")
    tstate = adamw_state_from_jax(_to_numpy(jstate), device="cpu")
    tgrads = lm_params_from_jax(grads, device="cpu")

    jnorm = joptim.global_norm(grads)
    tnorm = optim.global_norm(tgrads)
    assert tnorm.dtype == torch.float32
    assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
    jclipped, _ = joptim.clip_by_global_norm(1.0).update(
        jax.tree_util.tree_map(jnp.asarray, grads), ())
    tclipped, _ = optim.clip_by_global_norm(1.0).update(tgrads, ())
    for path, g in tree_items(tclipped):
        assert np.array_equal(_np(g), _np(_leaf(jclipped, path)))

    jup, jstate = jtx.update(jclipped, jstate, jparams)
    jnew = joptim.apply_updates(jparams, jup)
    ttx = optim.adamw(1e-3, weight_decay=0.1)
    tup, tstate = ttx.update(tclipped, tstate, tparams)
    tnew = optim.apply_updates(tparams, tup)
    assert int(tstate[0].count) == int(jstate[0].count) == 3
    for path, p in tree_items(tnew):
        assert np.array_equal(_np(p), _np(_leaf(jnew, path)))
        for field in ("mu", "nu"):
            assert np.array_equal(
                _np(_leaf(getattr(tstate[0], field), path)),
                _np(_leaf(getattr(jstate[0], field), path)))


def test_apply_update_rounds_like_the_reference():
    """A bfloat16 parameter takes the float32 update rounded to bfloat16
    first, then a bfloat16 add (one rounding of ``p + u`` would differ)."""
    rng = np.random.default_rng(2)
    p = rng.standard_normal(4096).astype(np.float32)
    u = (rng.standard_normal(4096) * 3e-3).astype(np.float32)
    want = _np(joptim.apply_updates(jnp.asarray(p, jnp.bfloat16),
                                    jnp.asarray(u)))
    tp = torch.tensor(p).bfloat16()
    got = optim.apply_update(tp, torch.tensor(u))
    assert got is tp and np.array_equal(_np(tp), want)
    assert not np.array_equal(_np((torch.tensor(p).bfloat16().float()
                                   + torch.tensor(u)).bfloat16()), want)


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("linear_schedule", (1e-3, 1e-5, 97)),
    ("warmup_cosine_schedule", (3e-4, 37, 1003, 0.1))])
def test_schedules_match(name, args):
    counts = np.arange(0, 1100, dtype=np.int32)
    want = np.asarray(getattr(jschedule, name)(*args)(jnp.asarray(counts)))
    got = getattr(tschedule, name)(*args)(torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32
    if name != "warmup_cosine_schedule":
        assert np.array_equal(got, want)
        return
    warmup = args[1]
    assert np.array_equal(got[:warmup + 1], want[:warmup + 1])
    assert np.abs(got - want).max() <= 1e-6 * args[0]


def test_pipeline_batches_are_bit_equal():
    for kwargs in ({"seed": 3}, {"seed": 0, "num_shards": 2,
                                 "shard_index": 1}):
        j = JTokenPipeline(vocab_size=200064, global_batch=4, seq_len=64,
                           **kwargs)
        t = TokenPipeline(vocab_size=200064, global_batch=4, seq_len=64,
                          **kwargs)
        for step in (0, 1, 17):
            a, b = j.batch(step), t.batch(step)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype == np.int32
                assert np.array_equal(a[key], b[key])
    assert t.shard(0, 1) == TokenPipeline(vocab_size=200064,
                                          global_batch=4, seq_len=64)


# ---------------------------------------------------------------------------
# Forward and the train step against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [128, 32])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match(name, seq):
    jcfg, jparams = _jax_smoke(name)
    tcfg = configs.get_smoke_config(name)
    tokens = np.random.default_rng(seq).integers(1, tcfg.vocab_size,
                                                 (2, seq))
    want, jaux = jforward(jcfg, jparams, jnp.asarray(tokens))
    params = lm_params_from_jax(_to_numpy(jparams), device="cpu")
    with torch.no_grad():
        got, aux = forward(tcfg, params, torch.as_tensor(tokens))
    assert got.shape == want.shape and float(aux) == float(jaux) == 0.0
    assert _rel(_np(got), _np(want)) <= 1e-4


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_match_the_jax_step(name, microbatches):
    jcfg, jparams = _jax_smoke(name)
    jtx = joptim.adamw(3e-4, weight_decay=0.1)
    jstate = jtx.init(jparams)
    jstep = jax.jit(jmake_train_step(jcfg, jtx, JTrainConfig(
        microbatches=microbatches)))
    tcfg = configs.get_smoke_config(name)
    params = lm_params_from_jax(_to_numpy(jparams), device="cpu")
    state = adamw_state_from_jax(_to_numpy(jstate), device="cpu")
    tstep = make_train_step(tcfg, optim.adamw(3e-4, weight_decay=0.1),
                            TrainConfig(microbatches=microbatches))
    pipe = TokenPipeline(vocab_size=tcfg.vocab_size, global_batch=4,
                         seq_len=128, seed=0)
    for step in range(3):
        batch = pipe.batch(step)
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        same, state, tm = tstep(params, state, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        assert same is params
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-6 * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            2e-3 * float(jm["grad_norm"])
        for path, p in tree_items(params):
            want = _np(_leaf(jparams, path))
            diff = np.abs(_np(p) - want)
            largest = np.abs(want).max()
            assert diff.max() <= 2e-2 * largest, path
            assert (diff > 1e-3 * largest).mean() <= 0.1, path
    assert int(state[0].count) == int(jstate[0].count) == 3


def test_remat_full_equals_none():
    """Activation checkpointing recomputes each layer with the same ops:
    the steps are equal, and the loss falls."""
    cfg = configs.get_smoke_config("phi4-mini-3.8b")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=2,
                         seq_len=128, seed=1)
    runs = []
    for remat in ("none", "full"):
        params = init_params(model_defs(cfg), torch.Generator().manual_seed(0),
                             "cpu")
        tx = optim.adamw(1e-3, weight_decay=0.1)
        state = tx.init(params)
        step = make_train_step(cfg, tx, TrainConfig(remat=remat))
        losses = []
        for i in range(3):
            batch = {k: torch.as_tensor(v) for k, v in pipe.batch(i).items()}
            params, state, m = step(params, state, batch)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((losses, params))
    assert runs[0][0] == runs[1][0]
    for (_, a), (_, b) in zip(tree_items(runs[0][1]),
                              tree_items(runs[1][1])):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="A11"):
        forward(cfg, runs[0][1], torch.ones((1, 8), dtype=torch.long),
                remat="dots")


# ---------------------------------------------------------------------------
# Trainer: loss goes down, resume == uninterrupted, preemption, watchdog
# (tests/test_infra.py's trainer tests, on the port)
# ---------------------------------------------------------------------------

def _make_trainer(monkeypatch, tmp_dir: str, total: int,
                  ckpt_every: int = 5, clock=None):
    """A smoke-size trainer whose clock is injected: ``clock``, a one-item
    list the caller advances, or by default a clock that each reading
    advances by 1 s, so that every step takes 1 s and the straggler
    watchdog never fires however loaded the machine is."""
    from repro_torch.training import trainer as trainer_mod

    if clock is None:
        ticks = itertools.count()

        def read():
            return float(next(ticks))
    else:
        def read():
            return clock[0]

    monkeypatch.setattr(trainer_mod, "time", type(
        "Clock", (), {"perf_counter": staticmethod(read)}))
    cfg = configs.get_smoke_config("phi4-mini-3.8b")
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    tx = optim.adamw(1e-3)
    step = make_train_step(cfg, tx, TrainConfig())
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=4,
                         seq_len=32, seed=0)
    return Trainer(step, pipe, params, tx.init(params),
                   TrainerConfig(total_steps=total,
                                 checkpoint_every=ckpt_every,
                                 checkpoint_dir=tmp_dir, log_every=1000),
                   to_batch=lambda b: {k: torch.as_tensor(v)
                                       for k, v in b.items()})


def test_trainer_loss_decreases(monkeypatch):
    out = _make_trainer(monkeypatch, "", total=30).run()
    losses = [m["loss"] for m in out["metrics"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_resume_equals_uninterrupted(tmp_path, monkeypatch):
    full = _make_trainer(monkeypatch, "", total=10).run()
    d = str(tmp_path / "ck")
    _make_trainer(monkeypatch, d, total=5, ckpt_every=5).run()
    t_b = _make_trainer(monkeypatch, d, total=10, ckpt_every=5)
    assert t_b.try_resume() and t_b.step == 5
    resumed = t_b.run()
    assert resumed["metrics"][-1]["loss"] == full["metrics"][-1]["loss"]


def test_preemption_checkpoints_and_stops(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    t = _make_trainer(monkeypatch, d, total=100)
    orig = t.train_step

    def step_and_preempt(*a):
        if t.step == 3:
            t._preempted = True      # as a SIGTERM would
        return orig(*a)

    t.train_step = step_and_preempt
    out = t.run()
    assert out["preempted"] and out["step"] == 4
    assert ckpt.latest_step(d) == 4


def test_watchdog_raises_on_stragglers(tmp_path, monkeypatch):
    """The trainer's clock is replaced by one that each step advances by 1 s,
    and by 100 s from step 7 on (an injected straggler), so the test does
    not depend on how fast the machine runs the steps."""
    clock = [0.0]
    t = _make_trainer(monkeypatch, str(tmp_path / "ck"), total=100,
                      clock=clock)
    t.tcfg.watchdog_warmup = 2
    t.tcfg.watchdog_limit = 2
    t.tcfg.watchdog_factor = 5.0
    orig = t.train_step

    def slow_step(*a):
        clock[0] += 100.0 if t.step >= 6 else 1.0
        return orig(*a)

    t.train_step = slow_step
    with pytest.raises(StragglerAbort):
        t.run()
    assert t.step == 8
    assert ckpt.latest_step(str(tmp_path / "ck")) == 8


def test_checkpoint_detects_corruption_and_falls_back(tmp_path):
    """Keep-k pruning, CRC verification and the fallback to the newest
    verifiable step, over a tree of bf16 and int32 tensors."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(12, dtype=torch.float32).bfloat16(),
            "s": (torch.tensor(3, dtype=torch.int32), ())}
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, step, tree, keep=3)
    assert ckpt.list_steps(d) == [2, 3, 4]
    step, flat, _ = ckpt.restore_checkpoint(d)
    back = ckpt.restore_into(tree, flat)
    assert step == 4 and torch.equal(back["w"], tree["w"])
    assert back["w"].dtype == torch.bfloat16 and back["s"][1] == ()
    path = os.path.join(d, "step_000000004", "tensors.pt")
    flat["w"] = flat["w"].clone()
    flat["w"][5] = 7.0                   # a flipped payload, intact file
    torch.save(flat, path)
    with pytest.raises(IOError, match="corruption detected in 'w'"):
        ckpt.restore_checkpoint(d)
    with open(path, "wb") as f:          # a torn write
        f.write(b"\0" * 16)
    with pytest.raises(Exception):
        ckpt.restore_checkpoint(d)
    assert ckpt.restore_checkpoint(d, fallback=True)[0] == 3


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_two_smoke_steps_on_the_cpu(capsys):
    out = train_cli.main(["--smoke", "--arch", "phi4-mini-3.8b", "--steps",
                          "2", "--global-batch", "2", "--seq", "128",
                          "--remat", "full", "--device", "cpu"])
    assert out["step"] == 2 and len(out["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert "done: 2 steps on cpu" in capsys.readouterr().out
    for flags, row in ((["--compress-grads", "0.1"], "A11"),
                       (["--devices", "4"], "A11")):
        with pytest.raises(NotImplementedError, match=row):
            train_cli.main(["--smoke", "--device", "cpu", *flags])
    arctic = dataclasses.replace(configs.get_smoke_config("yi-9b"),
                                 name="arctic-480b-smoke")
    with pytest.raises(NotImplementedError, match="A11e"):
        train_cli.make_optimizer(arctic)
