"""The learner kernels' own CUDA sources run on the CPU, held against their
plain PyTorch versions: ``csrc/ddpg_learn.cu`` and ``csrc/episode_learn.cu``
(with ``csrc/ddpg_update.cuh``) compiled by the host C++ compiler against
stub CUDA headers, one thread per block, as
``tests/test_torch_kernel_emulation.py`` (whose module docstring says what
this checks and what it cannot) builds them; the fixtures ``emulated`` and
``learner_division`` come from that module. These are its slow cases, in a
file of their own so that the two files run on two workers.

Tolerances (measured): ``ddpg_learn`` within 1e-6 x max|plain| per tensor
(measured 1.0e-7); ``episode_learn`` knob indices, restarts, keys, counts
and cursors EXACT, floats within 2e-6 relative (measured 4.5e-7); the
learners' Adam division and root bitwise IEEE (0 mismatches).
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch import random as jrandom
from repro_torch.core import DDPGConfig, MagpieAgent
from repro_torch.core.ddpg import DDPGState, ddpg_init
from repro_torch.core.episode import BufferState, EpisodeCarry
from repro_torch.core.scalarization import metric_bounds
from repro_torch.envs import LustreSimEnv, LustreSimV2
from repro_torch.envs.lustre_model import LustreEnvState
from repro_torch.kernels import ddpg_learn as dl
from repro_torch.kernels import episode_learn as el
from repro_torch.kernels.ddpg_learn import ddpg_learn_plain
from test_torch_kernel_emulation import _clone, _rel, emulated, \
    learner_division  # noqa: F401 (fixtures)


@pytest.mark.parametrize("m", [2, 8])
def test_ddpg_learn_source_matches_plain(emulated, m):
    cfg = DDPGConfig(12, m)
    n, u = 3, 6
    state = DDPGState(*(torch.stack(x) for x in zip(
        *[ddpg_init(jrandom.PRNGKey(i), cfg, "cpu") for i in range(n)])))
    rng = np.random.default_rng(0)

    def rows(*shape, normal=False):
        x = rng.standard_normal(shape) if normal else rng.random(shape)
        return torch.tensor(x, dtype=torch.float32)

    batches = (rows(n, u, 16, 12), rows(n, u, 16, m),
               rows(n, u, 16, normal=True), rows(n, u, 16, 12))
    plain, kern = _clone(state), _clone(state)
    want = ddpg_learn_plain(plain, batches, cfg=cfg)
    got = torch.empty((n, u, 3))
    fn = dl._bind(emulated["ddpg_learn"]).ddpg_learn_launch
    args = dl.launch_args(kern, batches, got, cfg, dl.check_smem_fit(cfg))
    err = fn(*args[:7], *(ctypes.addressof(x) for x in args[7:9]),
             *args[9:], None)
    assert err == 0
    assert torch.equal(kern.counts, plain.counts)
    assert _rel(kern.flat, plain.flat) <= 1e-6
    assert _rel(got, want) <= 1e-6


def _operands(env_cls, n=3, steps=6, updates=4, cap=8):
    """N sessions with their own env and agent seeds, warmup on the first
    two steps, a reward on throughput."""
    envs = [env_cls("seq_write", seed=s).to_model_env(device="cpu")
            for s in range(n)]
    cfg = DDPGConfig.for_env(envs[0], updates_per_step=updates)
    agents = [MagpieAgent(cfg, seed=s, warmup_steps=2, buffer_capacity=cap,
                          device="cpu") for s in range(n)]
    k, m = cfg.state_dim, cfg.action_dim
    rng = np.random.default_rng(1)
    lo, span = metric_bounds(envs[0].metric_specs, envs[0].state_metrics)
    w = np.zeros(k, np.float32)
    w[envs[0].state_metrics.index("throughput")] = 1.0
    carry = EpisodeCarry(
        LustreEnvState(torch.stack([e.model_state.key for e in envs]),
                       torch.stack([e.model_state.warmth for e in envs]),
                       torch.stack([e.model_state.last_values
                                    for e in envs])),
        DDPGState(*(torch.stack(x) for x in zip(*[a.state for a in agents]))),
        BufferState(torch.zeros(n, cap, k), torch.zeros(n, cap, m),
                    torch.zeros(n, cap), torch.zeros(n, cap, k),
                    torch.zeros(n, dtype=torch.int32),
                    torch.zeros(n, dtype=torch.int32)),
        torch.stack([a._learn_key for a in agents]),
        torch.full((n, k), 0.4), torch.full((n,), 0.4))
    use_warmup = torch.zeros(n, steps, dtype=torch.bool)
    use_warmup[:, :2] = True

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    op = el.EpisodeOperands(
        use_warmup, f32(rng.uniform(size=(n, steps, m))),
        f32(rng.normal(size=(n, steps, m)) * 0.1), f32(np.tile(w, (n, 1))),
        f32(np.tile(lo, (n, 1))), f32(np.tile(span, (n, 1))),
        torch.stack([e.params.vector() for e in envs]), carry)
    return op, el.EpisodeKernelSpec(envs[0].model, cfg, True, updates)


@pytest.mark.parametrize("env_cls", [LustreSimEnv, LustreSimV2])
def test_episode_learn_source_matches_plain(emulated, env_cls):
    op, spec = _operands(env_cls)
    kern = _clone(op)
    want = el.episode_learn_plain(op, spec=spec)
    draws = el.predraw(kern, spec)
    n, steps = kern.use_warmup.shape
    got = el._empty_trace(n, steps, spec.cfg, "cpu")
    fn = emulated["episode_learn"].episode_learn_launch
    fn.argtypes = [ctypes.c_void_p] * 7
    plan = el.check_smem_fit(spec.cfg, kern.carry.buffer.s.shape[1],
                             spec.model.n_samples)
    args = el.launch_args(kern, spec, *draws, got, plan)
    assert fn(*(ctypes.addressof(a) for a in args), None) == 0
    kern.carry.ddpg.step.add_(steps * spec.num_updates)
    for exact in ("action_idx", "restarts"):
        assert torch.equal(getattr(got, exact), getattr(want, exact))
    for name in ("metrics", "rewards", "objectives"):
        assert _rel(getattr(got, name), getattr(want, name)) <= 2e-6, name
    a, b = kern.carry, op.carry
    for x, y in ((a.ddpg.counts, b.ddpg.counts), (a.ddpg.step, b.ddpg.step),
                 (a.buffer.next_slot, b.buffer.next_slot),
                 (a.buffer.size, b.buffer.size),
                 (a.env_state.key, b.env_state.key),
                 (a.env_state.last_values, b.env_state.last_values),
                 (a.learn_key, b.learn_key)):
        assert torch.equal(x, y)
    for x, y in ((a.ddpg.flat, b.ddpg.flat), (a.state_vec, b.state_vec),
                 (a.objective, b.objective), (a.env_state.warmth,
                                              b.env_state.warmth),
                 *zip(a.buffer[:4], b.buffer[:4])):
        assert _rel(x, y) <= 2e-6



def test_learner_division_is_exact(learner_division):
    """The learners' Adam divides by ``div_exact`` (``__fdiv_rn``'s fast
    path with a 2^64 scaling for numerators below 2^-90 and a subnormal
    tie broken by the residual) and takes roots by ``sqrt_exact``, which
    must give the bits of IEEE division and square root over their
    ranges: numerators of every exponent up to 2^90 (zeros and subnormals
    included), subnormal quotients near the midpoint of two subnormals,
    and divisors in [2^-30, 2^10); roots of zeros, subnormals and normal
    numbers. Out of range the division says so. Bitwise: 0 mismatches of
    2^20 pairs (or arguments) of each kind."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    bits = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    b = ((bits | ((127 - 30 + rng.integers(0, 40, n, dtype=np.uint32))
                  << 23)).view(np.float32))
    exps = rng.integers(0, 127 + 90, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    a_any = (rng.integers(0, 1 << 23, n, dtype=np.uint32) | (exps << 23)
             | sign).view(np.float32)
    a_any[rng.integers(0, 1024, n) == 0] = 0.0
    a_sub = (rng.integers(0, 1 << 23, n, dtype=np.uint32)
             | (rng.integers(0, 37, n, dtype=np.uint32) << 23)
             | sign).view(np.float32)
    mid = ((rng.integers(0, 1 << 23, n) + 0.5) * 2.0 ** -149
           * b.astype(np.float64)).astype(np.float32)
    a_tie = np.maximum(mid.view(np.int32)
                       + rng.integers(-1, 2, n).astype(np.int32), 0
                       ).view(np.float32) * np.where(sign > 0, -1, 1
                                                    ).astype(np.float32)
    with np.errstate(all="ignore"):
        for a in (a_any, a_sub, a_tie):
            q, ok = learner_division(a, b)
            assert ok.all()
            np.testing.assert_array_equal(q.view(np.uint32),
                                          (a / b).view(np.uint32))
            x = np.abs(a)
            root, _ = learner_division(x, b, root=True)
            np.testing.assert_array_equal(root.view(np.uint32),
                                          np.sqrt(x).view(np.uint32))
        wide = np.array([2.0 ** 91, 1.0, 1.0], np.float32)
        _, ok = learner_division(wide, np.array([1.0, 2.0 ** -31, 2.0 ** 11],
                                                np.float32))
        assert not ok.any()
