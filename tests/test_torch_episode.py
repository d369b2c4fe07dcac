"""The episode kernel module (``repro_torch.kernels.episode_learn``) and the
single-session episode engine (``repro_torch.core.episode``): the pre-draw,
the shared-memory plan and its refusal, the CPU dispatch, the wrapper's
refusals, and (on a CUDA card only) the kernel against its plain version.
The plain version against the JAX package's megakernel formulation is held
in ``tests/test_torch_episode_reference.py``, on the operands
``port_operands`` below converts.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

from repro.kernels.ddpg_fused import unpack_params
from repro_torch import convert
from repro_torch.convert import AdamStateNumpy, DDPGStateNumpy
from repro_torch.core.action_mapping import ParamSpace, ParamSpec
from repro_torch.core.ddpg import DDPGConfig
from repro_torch.core.episode import EpisodeCarry, _encode_restart, \
    decode_restarts, run_episode_scan
from repro_torch.core.guardrails import DeploymentPolicy
from repro_torch.core.resilience import ResiliencePolicy
from repro_torch.envs import LustreSimEnv, LustreSimV2
from repro_torch.kernels import episode_learn as el
from repro_torch.kernels import ops
from repro_torch.kernels.ddpg_learn import work as learner_work

from tests.test_megakernel import _build

PAIRS = [("LustreSimEnv", LustreSimEnv), ("LustreSimV2", LustreSimV2)]


def _lead(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(1, *x.shape).contiguous()


def port_operands(op, spec, t_cls, device="cpu"):
    """The reference's one-session ``EpisodeOperands`` as the port's, N = 1
    (through ``convert``)."""
    cfg = DDPGConfig(*tuple(spec.cfg))
    p = unpack_params(*[np.asarray(x) for x in op.packed], spec.dims)
    tree = DDPGStateNumpy(
        p["actor"], p["critic"], p["actor_targ"], p["critic_targ"],
        (AdamStateNumpy(p["actor_count"], p["actor_mu"], p["actor_nu"]), ()),
        (AdamStateNumpy(p["critic_count"], p["critic_mu"], p["critic_nu"]),
         ()), np.int32(0))
    st = convert.ddpg_state_from_numpy(tree, cfg, device)
    env_state = convert.env_state_from_numpy(
        [np.asarray(x) for x in op.env], device)
    buf = convert.buffer_from_numpy([np.asarray(x) for x in op.buffer],
                                    device)
    params = convert.lustre_params_from_numpy(
        [np.asarray(x) for x in op.params], device)
    carry = EpisodeCarry(
        type(env_state)(*(_lead(x) for x in env_state)),
        type(st)(*(_lead(x) for x in st)), type(buf)(*(_lead(x) for x in buf)),
        _lead(convert.key_from_numpy(np.asarray(op.learn_key), device)),
        _lead(torch.as_tensor(np.array(op.state_vec), device=device)),
        _lead(torch.as_tensor(np.array(op.objective), device=device)))

    def t(x, dtype=torch.float32):
        return _lead(torch.as_tensor(np.array(x), dtype=dtype,
                                     device=device))

    pop = el.EpisodeOperands(
        t(op.use_warmup, torch.bool), t(op.warmup), t(op.noise), t(op.w_vec),
        t(op.lo), t(op.span), _lead(params.vector()), carry)
    model = t_cls("seq_write", seed=3).as_model()
    return pop, el.EpisodeKernelSpec(model, cfg, spec.learn,
                                     spec.num_updates)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(_clone(y) for y in x))


def test_predraw_is_the_two_key_chains():
    """The env draws are ``episode_draws`` of the env key; step t's
    minibatch indices are ``randint(kk_t, (U, B), 0, min(size0 + t + 1,
    cap))`` with ``kk_t`` split off the learner's key, as the reference's
    ``sample_minibatch_indices`` draws them."""
    from repro.core.ddpg import sample_minibatch_indices
    from repro.envs import LustreSimEnv as JE

    op, spec = _build(JE, T=6, U=3, cap=4)
    pop, pspec = port_operands(op, spec, LustreSimEnv)
    key0, lkey0 = pop.carry.env_state.key.clone(), pop.carry.learn_key.clone()
    env, mb = el.predraw(pop, pspec)
    assert env.shape == (1, 6, 135) and mb.shape == (1, 6, 3, 16)
    k, d = key0[0], []
    for _ in range(6):
        k, draws = pspec.model.step_draws(k)
        d.append(draws)
    assert torch.equal(env[0], torch.stack(d))
    assert torch.equal(pop.carry.env_state.key[0], k)
    jkey = jax.numpy.asarray(np.asarray(lkey0[0]).astype(np.uint32))
    for t in range(6):
        jkey, kk = jax.random.split(jkey)
        want = sample_minibatch_indices(kk, 3, 16, min(t + 1, 4))
        np.testing.assert_array_equal(mb[0, t].numpy(), np.asarray(want))
    np.testing.assert_array_equal(pop.carry.learn_key[0].numpy(),
                                  np.asarray(jkey).astype(np.int64))


def test_smem_plan_and_its_refusal():
    """The plan counts floats part by part, the session's whole learner
    state first (222,972 B on 8-D and 207,516 B on 2-D at capacity 64, one
    block may opt into 232,448 B), and a replay window that does not fit is
    refused before any launch, naming the knob to lower."""
    plan = el.smem_plan(12, 8, (64, 64), 16, 64, 12)
    assert list(plan) == ["learner_state", "learner", "replay_window",
                          "state_rows", "env_samples", "total"]
    assert plan["learner_state"] == 177_296
    assert plan["learner"] == 36_556
    assert plan["replay_window"] == 4 * 64 * (2 * 12 + 8 + 1)
    assert plan["state_rows"] == 4 * 2 * 12
    assert plan["env_samples"] == 4 * 12 * 12
    assert plan["total"] == 222_972
    assert plan["total"] == sum(v for k, v in plan.items() if k != "total")
    assert el.smem_plan(12, 2, (64, 64), 16, 64, 12)["total"] == 207_516
    assert plan["total"] < el.SMEM_LIMIT
    cfg = DDPGConfig(12, 8)
    assert el.check_smem_fit(cfg, 64, 12) == plan
    with pytest.raises(ValueError, match="buffer_capacity"):
        el.check_smem_fit(cfg, 4096, 12)
    # the wrapper refuses it too, before it looks for a card
    from repro.envs import LustreSimEnv as JE

    op, spec = _build(JE, T=2, U=2, cap=2048)
    pop, pspec = port_operands(op, spec, LustreSimEnv)
    with pytest.raises(ValueError, match="buffer_capacity"):
        el.episode_learn(pop, spec=pspec)


def test_cpu_dispatch_runs_the_plain_version(monkeypatch):
    from repro.envs import LustreSimV2 as JV

    monkeypatch.setattr(el.episode_learn, "launches", 0)
    op, spec = _build(JV, T=4, U=2, cap=4)
    a, aspec = port_operands(op, spec, LustreSimV2)
    b = _clone(a)
    got = ops.episode_inner_loop(a, spec=aspec)
    want = el.episode_learn_plain(b, spec=aspec)
    assert el.episode_learn.launches == 0
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)


def test_wrapper_refusals():
    from repro.envs import LustreSimEnv as JE

    op, spec = _build(JE, T=2, U=2, cap=4)
    pop, pspec = port_operands(op, spec, LustreSimEnv)
    with pytest.raises(ValueError, match="CUDA"):
        el.episode_learn(_clone(pop), spec=pspec)
    with pytest.raises(ValueError, match="A5"):
        el.episode_learn_plain(_clone(pop), spec=pspec._replace(
            model=object()))
    model = LustreSimEnv("seq_write").as_model()
    model.param_space = ParamSpace(specs=(
        ParamSpec("stripe_count", "continuous", minimum=1, maximum=6),
        model.param_space.specs[1]))
    with pytest.raises(ValueError, match="quantized"):
        el.episode_learn_plain(_clone(pop), spec=pspec._replace(model=model))
    bad = pop._replace(noise=pop.noise.double())
    with pytest.raises(ValueError, match="noise"):
        el.episode_learn_plain(bad, spec=pspec)
    bad = pop._replace(w_vec=pop.w_vec[:, :5].contiguous())
    with pytest.raises(ValueError, match="w_vec"):
        el.episode_learn_plain(bad, spec=pspec)
    env = LustreSimEnv("seq_write").to_model_env(device="cpu")
    for kwargs, error, match in (
            ({"policy": DeploymentPolicy(),
              "resilience": ResiliencePolicy()}, ValueError, "compose"),
            ({"resilience": ResiliencePolicy()}, ValueError, "HealthState"),
            ({"policy": DeploymentPolicy(), "guard": object(),
              "obs_mask": (1.0,) * 12}, ValueError, "compose")):
        with pytest.raises(error, match=match):
            run_episode_scan(env, None, None, {}, 1, **kwargs)


def test_space_desc_and_work():
    model = LustreSimV2("seq_write").as_model()
    ints, floats = el.space_desc(model)
    assert len(ints) == 58 and len(floats) == 304
    m = model.param_space.dim
    assert ints[0] == m
    names = model.param_space.names
    assert ints[1 + 48:1 + 48 + 8] == [names.index(k)
                                       for k in el.NAMED_KNOBS]
    assert ints[-1] == sum(1 << names.index(k)
                           for k in ("service_threads", "checksums"))
    cfg = DDPGConfig(12, 8)
    one = el.work(cfg, 1, 1)
    assert el.work(cfg, 16, 30)["flops"] == 16 * 30 * one["flops"]
    assert 0 < one["flops"] - learner_work(cfg, 1, 96)["flops"] < 20_000
    assert el.work(cfg, 4, 30)["bytes"] == 4 * el.work(cfg, 1, 30)["bytes"]


def test_restart_fixed_point_round_trips():
    costs = torch.tensor([0.0, 12.0, 12.5, 19.999998, 42.0, 49.99999],
                         dtype=torch.float32)
    fp = _encode_restart(costs)
    assert fp.dtype == torch.int32
    np.testing.assert_array_equal(decode_restarts(fp.numpy()),
                                  costs.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name,t_cls", PAIRS)
def test_kernel_matches_plain_on_the_card(name, t_cls, monkeypatch):
    """Run on a CUDA card with nvcc: the kernel against its plain version on
    the reference's small operands, on the card. Two launches bitwise
    equal; keys and counts exact; the warmup decisions equal; trace floats
    before the first differing decision within 1e-5 relative (chip_smoke.py
    measured 1.1e-7 median, 3.0e-7 worst, over 30-step episodes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro.envs import LustreSimEnv as JE, LustreSimV2 as JV

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    op, spec = _build(JE if name == "LustreSimEnv" else JV)
    pop, pspec = port_operands(op, spec, t_cls, device="cuda")
    k1, k2, p = _clone(pop), _clone(pop), _clone(pop)
    t1 = el.episode_learn(k1, spec=pspec)
    t2 = el.episode_learn(k2, spec=pspec)
    tp = el.episode_learn_plain(p, spec=pspec)
    torch.cuda.synchronize()
    for x, y in zip(t1, t2):
        assert torch.equal(x, y)
    assert torch.equal(k1.carry.ddpg.counts, p.carry.ddpg.counts)
    assert torch.equal(k1.carry.env_state.key, p.carry.env_state.key)
    same = (t1.action_idx == tp.action_idx).all(dim=-1)[0]
    first = int(same.logical_not().int().argmax()) if not bool(same.all()) \
        else same.numel()
    assert first >= int(pop.use_warmup[0].sum())  # warmup decisions equal
    for a, b in ((t1.metrics, tp.metrics), (t1.rewards, tp.rewards)):
        a, b = a[0, :first], b[0, :first]
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert ctypes.sizeof(ctypes.c_void_p) == 8
