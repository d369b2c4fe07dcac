"""The ``ddpg_learn`` kernel module: the weight conversion, the shared-memory
plan and its refusals, the CPU dispatch, the wrapper's input checks, and (on
a CUDA card only) the kernel against its plain version. Its plain version
against the JAX package's reference is held in
``tests/test_torch_kernel_ddpg_reference.py``.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

from repro.core import ddpg as j_ddpg
from repro_torch import random as jrandom
from repro_torch.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
from repro_torch.core.ddpg import DDPGConfig, DDPGState, ddpg_init, \
    state_layout, unflatten
from repro_torch.kernels import build, ops
from repro_torch.kernels import ddpg_learn as dl
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


def test_smem_plan_holds_the_learner_state():
    """One block holds a session's whole learner state (parameters, targets
    and both Adam moments) and one update's scratch: 199,932 B on 2-D and
    213,852 B on 8-D at the paper's learner, of the 232,448 B a block may
    use. A configuration over that is refused before any launch, naming the
    knobs to lower, and so are widths the kernel is not built for."""
    for m, state, scratch in ((2, 164_912, 35_020), (8, 177_296, 36_556)):
        cfg = DDPGConfig(12, m)
        plan = dl.smem_plan(cfg)
        assert plan == {"learner_state": state, "learner": scratch,
                        "total": state + scratch}
        assert plan["learner_state"] == 4 * state_layout(cfg).floats
        assert dl.check_smem_fit(cfg) == plan
    assert dl.smem_plan(DDPGConfig(12, 2))["total"] == 199_932
    assert dl.smem_plan(DDPGConfig(12, 8))["total"] == 213_852
    assert 213_852 < dl.SMEM_LIMIT == 232_448
    wide = DDPGConfig(12, 2, hidden=(128, 128))
    with pytest.raises(ValueError, match="lower the hidden widths"):
        dl.check_smem_fit(wide)
    # the wrapper refuses it too, before it looks for a card
    state, batches = _fleet(wide, 1, updates=1)
    with pytest.raises(ValueError, match="lower the hidden widths"):
        ddpg_learn(state, batches, cfg=wide)
    with pytest.raises(ValueError, match="built for hidden"):
        dl.check_smem_fit(DDPGConfig(12, 2, hidden=(32, 32)))


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
