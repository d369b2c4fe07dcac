"""The episode kernel module's plain version against the JAX package's
megakernel formulation: ``episode_fused_xla`` and ``episode_fused_ref`` on
the reference's own small operands (``tests/test_megakernel.py::_build``:
T = 5 steps, U = 4 updates, capacity 8), converted by
``tests/test_torch_episode.py::port_operands``. (The module's fast checks
are ``tests/test_torch_episode.py``.)

Tolerances, measured before pinning:

* knob indices, restart fixed points, both key chains, replay cursors and
  Adam counts EXACT;
* trace and replay floats within 64 float32 ulps (measured 3 on 2-D, 20 on
  8-D: the env step's few ulps, tests/test_torch_env_model.py, carried
  through the normalization and the reward);
* learner tensors within 1e-5 x max|ref| (measured 8.9e-7 / 1.1e-6).
"""

import jax
import numpy as np
import pytest

from repro.kernels.ddpg_fused import unpack_params
from repro.kernels.episode_fused import episode_fused_xla
from repro.kernels.ref import episode_fused_ref
from repro_torch.core.ddpg import unflatten
from repro_torch.kernels import episode_learn as el

from tests.test_megakernel import _build
from tests.test_torch_episode import PAIRS, port_operands

TRACE_ULPS = 64
LEARNER_RTOL = 1e-5


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("name,t_cls", PAIRS)
def test_plain_matches_the_reference_formulations(name, t_cls):
    from repro.envs import LustreSimEnv as JE, LustreSimV2 as JV

    op, spec = _build(JE if name == "LustreSimEnv" else JV)
    opf = jax.tree_util.tree_map(lambda x: x[None], op)
    twin = jax.tree_util.tree_map(lambda x: np.asarray(x)[0],
                                  episode_fused_xla(opf, spec=spec))
    oracle = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda o: episode_fused_ref(o, spec=spec))(op))
    pop, pspec = port_operands(op, spec, t_cls)
    trace = el.episode_learn_plain(pop, spec=pspec)
    c = pop.carry
    for ref in (twin, oracle):
        np.testing.assert_array_equal(trace.action_idx[0].numpy(),
                                      ref.action_idx)
        np.testing.assert_array_equal(trace.restarts[0].numpy(),
                                      ref.restarts)
        np.testing.assert_array_equal(c.env_state.key[0].numpy(),
                                      np.asarray(ref.env[0]).astype(np.int64))
        np.testing.assert_array_equal(c.learn_key[0].numpy(),
                                      np.asarray(ref.learn_key)
                                      .astype(np.int64))
        assert int(c.buffer.next_slot[0]) == int(ref.buffer[4])
        assert int(c.buffer.size[0]) == int(ref.buffer[5])
        for got, want in ((trace.metrics[0], ref.metrics),
                          (trace.rewards[0], ref.rewards),
                          (trace.objectives[0], ref.objectives),
                          (c.state_vec[0], ref.state_vec),
                          (c.objective[0], ref.objective),
                          (c.env_state.warmth[0], ref.env[1]),
                          *zip([b[0] for b in c.buffer[:4]],
                               ref.buffer[:4])):
            assert _ulps(got.numpy(), want) <= TRACE_ULPS
    want = unpack_params(*twin.packed, spec.dims)
    got = unflatten(c.ddpg.flat[0], pspec.cfg)
    for net in ("actor", "critic", "actor_targ", "critic_targ", "actor_mu",
                "actor_nu", "critic_mu", "critic_nu"):
        for g, w in zip(got[net], want[net]):
            for key in ("w", "b"):
                w_ = np.asarray(w[key])
                err = np.abs(g[key].numpy() - w_).max()
                assert err <= LEARNER_RTOL * max(np.abs(w_).max(), 1e-30)
    t_steps, u = op.use_warmup.shape[0], spec.num_updates
    assert c.ddpg.counts[0].tolist() == [int(want["actor_count"]),
                                         int(want["critic_count"])]
    assert c.ddpg.counts[0].tolist() == [t_steps * u] * 2
    assert int(c.ddpg.step[0]) == t_steps * u
