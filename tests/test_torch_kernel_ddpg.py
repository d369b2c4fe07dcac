"""The ``ddpg_learn`` kernel module: its plain PyTorch version against the
JAX package's oracle ``kernels/ref.py::ddpg_fused_ref``, the weight
conversion, the CPU dispatch, the wrapper's input checks, and (on a CUDA
card only) the kernel against its plain version.

Tolerance of the plain version vs the oracle, 96 updates over 3 sessions:
Adam counts exact; per session and float tensor, max|port - ref| <=
1e-4 x max|ref| (measured 5.5e-6 on 2-D and 4.0e-5 on 8-D; see
tests/test_torch_ddpg.py for why the bound is relative to the tensor's
magnitude and not in ulps).
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

from repro.core import ddpg as j_ddpg
from repro.kernels import ddpg_fused as fused
from repro.kernels import ref
from repro_torch import random as jrandom
from repro_torch.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
from repro_torch.core.ddpg import DDPGConfig, DDPGState, ddpg_init, \
    state_layout, unflatten
from repro_torch.kernels import build, ops
from repro_torch.kernels.ddpg_learn import ddpg_learn, ddpg_learn_plain, \
    work

DIMS = [(12, 2), (12, 8)]
UPDATES = 96


def _fleet(cfg, n, seed=0, updates=UPDATES):
    """N independent ``ddpg_init`` learners on the CPU and their
    minibatches from a 64-row replay each, made with numpy."""
    states = [ddpg_init(jrandom.PRNGKey(seed + i), cfg, "cpu")
              for i in range(n)]
    state = DDPGState(*(torch.stack(xs) for xs in zip(*states)))
    rng = np.random.default_rng(seed)
    k, m, b = cfg.state_dim, cfg.action_dim, cfg.batch_size
    replay = [rng.random((n, 64, k)), rng.random((n, 64, m)),
              rng.standard_normal((n, 64)), rng.random((n, 64, k))]
    idx = rng.integers(0, 64, (n, updates, b))
    rows = np.arange(n)[:, None, None]
    batches = tuple(torch.from_numpy(x[rows, idx].astype(np.float32))
                    for x in replay)
    return state, batches


def _clone(state):
    return DDPGState(*(t.clone() for t in state))


def _rel(got, want) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


@pytest.mark.parametrize("k,m", DIMS)
def test_plain_matches_ref_oracle_per_session(k, m):
    """Pack each session's real-size state into the reference's padded
    [P, P] layout and run ``ddpg_fused_ref`` on it, as the JAX tests do."""
    cfg = DDPGConfig(k, m)
    state, batches = _fleet(cfg, 3)
    plain = _clone(state)
    metrics = ddpg_learn_plain(plain, batches, cfg=cfg)
    dims = fused.packed_dims(k, m, cfg.hidden)
    for i in range(3):
        tree = ddpg_state_to_numpy(
            DDPGState(state.flat[i], state.counts[i], state.step[i]), cfg)
        a_adam, c_adam = tree.actor_opt[0], tree.critic_opt[0]
        packed = fused.pack_params(
            tree.actor, tree.critic, tree.actor_targ, tree.critic_targ,
            a_adam.mu, a_adam.nu, c_adam.mu, c_adam.nu, a_adam.count,
            c_adam.count, dims)
        kb = fused.pack_minibatches(tuple(b[i].numpy() for b in batches),
                                    dims)
        r_packed, r_ms = ref.ddpg_fused_ref(
            packed, kb, state_dim=k, action_dim=m, pad=dims.pad,
            gamma=cfg.gamma, tau=cfg.tau, actor_lr=cfg.actor_lr,
            critic_lr=cfg.critic_lr)
        want = fused.unpack_params(*r_packed, dims)
        got = ddpg_state_to_numpy(
            DDPGState(plain.flat[i], plain.counts[i], plain.step[i]), cfg)
        assert int(got.actor_opt[0].count) == int(want["actor_count"])
        assert int(got.critic_opt[0].count) == int(want["critic_count"])
        assert int(got.step) == UPDATES
        pairs = {"actor": got.actor, "critic": got.critic,
                 "actor_targ": got.actor_targ,
                 "critic_targ": got.critic_targ,
                 "actor_mu": got.actor_opt[0].mu,
                 "actor_nu": got.actor_opt[0].nu,
                 "critic_mu": got.critic_opt[0].mu,
                 "critic_nu": got.critic_opt[0].nu}
        for name, net in pairs.items():
            for g, w in zip(net, want[name]):
                for key in ("w", "b"):
                    assert _rel(g[key], w[key]) <= 1e-4, (i, name, key)
        for j, key in enumerate(("critic_loss", "actor_loss", "q_mean")):
            assert _rel(metrics[i, :, j].numpy(), r_ms[key]) <= 1e-4


@pytest.mark.parametrize("k,m", DIMS)
def test_convert_round_trips_bitwise(k, m):
    jcfg = j_ddpg.DDPGConfig(k, m)
    jstate, _ = j_ddpg.ddpg_init(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    cfg = DDPGConfig(k, m)
    port = ddpg_state_from_numpy(tree, cfg, "cpu")
    back = ddpg_state_to_numpy(port, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    again = ddpg_state_from_numpy(back, cfg, "cpu")
    for a, b in zip(again, port):
        assert torch.equal(a, b)
    assert port.flat.shape == (state_layout(cfg).floats,)


def test_layout_sizes_are_the_real_sizes():
    """Learner state per session: 164,920 B on 2-D and 177,304 B on 8-D
    (float32 weights and moments plus two int32 counts)."""
    for m, want in ((2, 164_920), (8, 177_304)):
        assert 4 * (state_layout(DDPGConfig(12, m)).floats + 2) == want
    offsets = state_layout(DDPGConfig(12, 2)).flat_offsets()
    assert len(offsets) == 48 and offsets == sorted(offsets)


def test_cpu_dispatch_runs_the_plain_version(monkeypatch):
    monkeypatch.setattr(ddpg_learn, "launches", 0)
    cfg = DDPGConfig(12, 2)
    state, batches = _fleet(cfg, 2, updates=4)
    a, b = _clone(state), _clone(state)
    got = ops.ddpg_inner_loop(a, batches, cfg=cfg)
    want = ddpg_learn_plain(b, batches, cfg=cfg)
    assert ddpg_learn.launches == 0
    assert torch.equal(got, want)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.counts.tolist() == [[4, 4], [4, 4]]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    cfg = DDPGConfig(12, 2)
    state, batches = _fleet(cfg, 2, updates=2)
    with pytest.raises(ValueError, match="CUDA"):
        ddpg_learn(state, batches, cfg=cfg)
    s, a, r, s2 = batches
    bad = [(s.double(), a, r, s2), (s[:, :, :8], a, r, s2),
           (s, a.transpose(2, 3).contiguous().transpose(2, 3), r, s2),
           (s, a, r[:, :1], s2)]
    for b in bad:
        with pytest.raises(ValueError):
            ddpg_learn_plain(_clone(state), b, cfg=cfg)
    with pytest.raises(ValueError, match="hidden"):
        ddpg_learn_plain(state, batches, cfg=cfg._replace(hidden=(64,)))
    with pytest.raises(ValueError, match="flat"):
        ddpg_learn_plain(DDPGState(state.flat[:, :-1].contiguous(),
                                   state.counts, state.step), batches,
                         cfg=cfg)


def test_work_counts_scale_with_sessions_and_updates():
    cfg = DDPGConfig(12, 2)
    one = work(cfg, 1, 1)
    assert work(cfg, 8, 96)["flops"] == 8 * 96 * one["flops"]
    floats = state_layout(cfg).floats
    assert work(cfg, 3, 96)["bytes"] == 3 * (
        2 * 4 * (floats + 2) + 4 * 96 * 16 * (2 * 12 + 2 + 1) + 4 * 96 * 3)
    assert 1.5e6 < one["flops"] < 2.5e6  # ~1.85 MFLOP per session-update


def test_build_targets_the_listed_sources(tmp_path, monkeypatch):
    """Every kernel builds from ``csrc``; a library's name hashes its source
    and every header it includes, so an edited shared header gives the
    kernels that include it new names, never a stale build, and leaves the
    others' alone: ``ddpg_update.cuh`` the two learners',
    ``tma_wgmma.cuh`` the tensor-core kernels' (the flash backward, the
    flash forward, gmm, ssd_scan and wkv6_scan)."""
    learners = ["ddpg_learn", "episode_learn"]
    tensor_cores = ["flash_attention_bwd", "flash_attention_fwd", "gmm",
                    "ssd_scan", "wkv6_scan"]
    others = ["flash_attention_bwd", "flash_attention_fwd", "gmm",
              "ssd_scan", "wkv6_scan"]
    assert build.sources() == learners + others
    for name in build.sources():
        target = build._target(name)
        assert target.parent == build.BUILD_DIR
        assert target.name.startswith(f"lib{name}-")
        headers = ["ddpg_update.cuh"] if name in learners else \
            ["tma_wgmma.cuh"] if name in tensor_cores else []
        assert [p.name for p in build.dependencies(name)] == \
            [f"{name}.cu"] + headers
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    for header, users in (("ddpg_update.cuh", learners),
                          ("tma_wgmma.cuh", tensor_cores)):
        before = {n: build._target(n).name for n in build.sources()}
        path = tmp_path / header
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        after = {n: build._target(n).name for n in build.sources()}
        assert all(before[n] != after[n] for n in users)
        assert all(before[n] == after[n] for n in build.sources()
                   if n not in users)


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", DIMS)
def test_kernel_matches_plain_on_the_card(k, m, monkeypatch):
    """Run on a CUDA card with nvcc: the kernel against its plain version at
    the main path's shapes. Counts exact, two launches bitwise equal, the
    median session within 1e-5 (the bound ``chip_smoke.py`` holds it to)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = DDPGConfig(k, m)
    state, batches = _fleet(cfg, 64)
    state = DDPGState(*(t.cuda() for t in state))
    batches = tuple(b.cuda() for b in batches)
    k1, k2, p = _clone(state), _clone(state), _clone(state)
    m1 = ddpg_learn(k1, batches, cfg=cfg)
    m2 = ddpg_learn(k2, batches, cfg=cfg)
    mp = ddpg_learn_plain(p, batches, cfg=cfg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    assert torch.equal(m1, m2)
    assert torch.equal(k1.counts, p.counts) and torch.equal(k1.step, p.step)
    got, want = unflatten(k1.flat, cfg), unflatten(p.flat, cfg)
    rel = torch.zeros(64, dtype=torch.float64, device="cuda")
    for name in got:
        for g, w in zip(got[name], want[name]):
            for key in ("w", "b"):
                diff = (g[key] - w[key]).abs().reshape(64, -1).amax(1)
                scale = w[key].abs().reshape(64, -1).amax(1).clamp_min(1e-30)
                rel = torch.maximum(rel, (diff / scale).double())
    assert float(rel.median()) <= 1e-5
    assert ctypes.sizeof(ctypes.c_void_p) == 8


@pytest.mark.parametrize("k,m", DIMS)
def test_plain_fleet_matches_reference_in_the_median(k, m):
    """64 independent sessions x 96 updates, plain version vs the
    reference's ``_ddpg_step`` scan. Most sessions agree to a few 1e-6 of
    each tensor's magnitude; a few diverge far more (a ReLU input or a
    gradient within rounding of 0 takes the other sign, and Adam's first
    steps turn any nonzero gradient into a full learning-rate step). That is
    why the kernel is held to the median and 90th-percentile session; this
    test holds the plain version to the reference the same way: median <=
    1e-5, p90 <= 2e-4 (measured median 3.4e-6 / 2.4e-6, p90 5.6e-5 /
    2.8e-5, max 1.2e-3 / 0.18 on 2-D / 8-D)."""
    from repro.optim.transform import ScaleByAdamState

    cfg = DDPGConfig(k, m)
    n = 64
    state, batches = _fleet(cfg, n, seed=100)
    plain = _clone(state)
    ddpg_learn_plain(plain, batches, cfg=cfg)
    jcfg = j_ddpg.DDPGConfig(k, m)
    _, (atx, ctx) = j_ddpg.ddpg_init(jax.random.PRNGKey(0), jcfg)
    run = jax.jit(lambda st, bt: jax.lax.scan(
        lambda c, b: j_ddpg._ddpg_step(c, b, jcfg, atx, ctx), st, bt)[0])
    errs = []
    for i in range(n):
        t = ddpg_state_to_numpy(
            DDPGState(state.flat[i], state.counts[i], state.step[i]), cfg)
        jstate = j_ddpg.DDPGState(
            t.actor, t.critic, t.actor_targ, t.critic_targ,
            (ScaleByAdamState(*t.actor_opt[0]), ()),
            (ScaleByAdamState(*t.critic_opt[0]), ()), t.step)
        want = jax.tree_util.tree_leaves(
            run(jstate, tuple(b[i].numpy() for b in batches)))
        got = jax.tree_util.tree_leaves(ddpg_state_to_numpy(
            DDPGState(plain.flat[i], plain.counts[i], plain.step[i]), cfg))
        err = 0.0
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            if g.dtype != np.float32:
                np.testing.assert_array_equal(g, w)
                continue
            err = max(err, _rel(g, w))
        errs.append(err)
    assert np.median(errs) <= 1e-5
    assert np.quantile(errs, 0.9) <= 2e-4
