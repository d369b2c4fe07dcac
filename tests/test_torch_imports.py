"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, and the port's entry points
refuse to run without a card unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_the_scan_engine_slice_is_covered():
    """The import checks below walk every module of the port, the scan
    engine's included."""
    mods = _port_modules()
    for name in ("repro_torch.core.episode", "repro_torch.envs.lustre_model",
                 "repro_torch.kernels.episode_learn", "repro_torch.random",
                 "repro_torch.convert", "repro_torch.kernels.ops"):
        assert name in mods, name
    assert {p.name for p in (PORT / "kernels" / "csrc").iterdir()} >= {
        "ddpg_learn.cu", "episode_learn.cu", "ddpg_update.cuh"}


def test_the_lm_serving_slice_is_covered():
    """The import checks below walk the LM serving slice's subpackages and
    the flash-attention kernel too."""
    mods = _port_modules()
    for name in ("repro_torch.models", "repro_torch.models.base",
                 "repro_torch.models.attention", "repro_torch.models.ffn",
                 "repro_torch.models.transformer", "repro_torch.configs",
                 "repro_torch.configs.yi_9b", "repro_torch.training.steps",
                 "repro_torch.launch.serve",
                 "repro_torch.kernels.flash_attention"):
        assert name in mods, name
    assert (PORT / "kernels" / "csrc" / "flash_attention_fwd.cu").exists()


def test_the_training_slice_is_covered():
    """The import checks below walk the training slice's modules and the
    flash-attention backward kernel too."""
    mods = _port_modules()
    for name in ("repro_torch.optim.transform", "repro_torch.optim.adamw",
                 "repro_torch.optim.schedule", "repro_torch.optim.adafactor",
                 "repro_torch.training.losses", "repro_torch.training.steps",
                 "repro_torch.training.trainer", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.store", "repro_torch.launch.train",
                 "repro_torch.models.transformer", "repro_torch.convert",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.ops"):
        assert name in mods, name
    assert (PORT / "kernels" / "csrc" / "flash_attention_bwd.cu").exists()


def test_the_moe_serving_slice_is_covered():
    """The import checks below walk the MoE slice's modules and the ``gmm``
    kernel too."""
    mods = _port_modules()
    for name in ("repro_torch.models.moe", "repro_torch.kernels.gmm",
                 "repro_torch.configs.deepseek_moe_16b",
                 "repro_torch.configs.arctic_480b"):
        assert name in mods, name
    assert (PORT / "kernels" / "csrc" / "gmm.cu").exists()


def test_the_hybrid_serving_slice_is_covered():
    """The import checks below walk the hybrid slice's modules and the
    ``ssd_scan`` kernel too."""
    mods = _port_modules()
    for name in ("repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
                 "repro_torch.configs.zamba2_7b"):
        assert name in mods, name
    assert (PORT / "kernels" / "csrc" / "ssd_scan.cu").exists()


def test_the_rwkv_slice_is_covered():
    """The import checks below walk the RWKV6 slice's modules and the
    ``wkv6_scan`` kernel too."""
    mods = _port_modules()
    for name in ("repro_torch.models.rwkv", "repro_torch.kernels.wkv6_scan",
                 "repro_torch.configs.rwkv6_3b",
                 "repro_torch.models.transformer", "repro_torch.kernels.ops",
                 "repro_torch.launch.serve"):
        assert name in mods, name
    assert (PORT / "kernels" / "csrc" / "wkv6_scan.cu").exists()


def test_the_fleet_slice_is_covered():
    """The import checks below walk the fleet runtime's modules too."""
    mods = _port_modules()
    for name in ("repro_torch.core.fleet", "repro_torch.core.episode",
                 "repro_torch.core.replay_buffer", "repro_torch.core.ddpg"):
        assert name in mods, name


def test_the_service_slice_is_covered():
    """The import checks below walk the persistent service's modules
    too."""
    mods = _port_modules()
    for name in ("repro_torch.core.service", "repro_torch.core.fleet",
                 "repro_torch.core.episode", "repro_torch.checkpoint.store"):
        assert name in mods, name


def test_the_guardrails_slice_is_covered():
    """The import checks below walk the deployment guardrails and the fault
    injection too."""
    mods = _port_modules()
    for name in ("repro_torch.core.guardrails", "repro_torch.envs.faults",
                 "repro_torch.core.episode", "repro_torch.core.tuner"):
        assert name in mods, name


def test_the_resilience_slice_is_covered():
    """The import checks below walk the self-healing layer, the supervised
    chunk stream and the host chaos too."""
    mods = _port_modules()
    for name in ("repro_torch.core.resilience", "repro_torch.envs.faults",
                 "repro_torch.core.episode", "repro_torch.core.service"):
        assert name in mods, name


def test_the_sharing_slice_is_covered():
    """The import checks below walk experience sharing, the observation
    scopes and the grouped replay buffer too."""
    mods = _port_modules()
    for name in ("repro_torch.core.sharing", "repro_torch.envs.metrics",
                 "repro_torch.core.replay_buffer", "repro_torch.core.fleet"):
        assert name in mods, name


def test_no_source_file_imports_jax_or_repro():
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_everything_loads_neither_jax_nor_repro():
    """In a fresh interpreter with no card visible: import every module of
    the port and everything the packages expose; then a ``Tuner``, a
    ``FleetAgent``, a ``FleetTuner`` (built directly and by ``from_grid``,
    on both engines) and a ``FleetService`` built without ``device=`` must
    raise, and ones on the CPU must work."""
    code = f"""
import importlib, sys
mods = {_port_modules()!r}
for name in mods:
    mod = importlib.import_module(name)
    for attr in getattr(mod, "__all__", []):
        getattr(mod, attr)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
from repro_torch.core import Scalarizer, Tuner
from repro_torch.envs import LustreSimEnv
env = LustreSimEnv("seq_write")
scal = Scalarizer(weights={{"throughput": 1.0}}, specs=env.metric_specs)
try:
    Tuner(env, scal)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("Tuner without a card and without device= ran")
Tuner(env, scal, eval_runs=1, device="cpu")
try:
    env.to_model_env()
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("ModelEnv without a card and without device= ran")
menv = env.to_model_env(device="cpu")
Tuner(menv, scal, eval_runs=1, engine="scan", device="cpu").run(2)
from repro_torch.core import DDPGConfig, FleetAgent, FleetTuner
grid = (["seq_write"], [{{"throughput": 1.0}}], [0, 1])
for build in (lambda: FleetAgent(DDPGConfig(12, 2), [0, 1]),
              lambda: FleetTuner.from_grid(*grid, eval_runs=1),
              lambda: FleetTuner.from_grid(*grid, eval_runs=1,
                                           engine="scan")):
    try:
        build()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("a fleet without a card and without device= ran")
cpu_agent = FleetAgent(DDPGConfig(12, 2), [0, 1], device="cpu")
try:
    FleetTuner([env, env], [scal, scal], cpu_agent)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("FleetTuner without a card and without device= ran")
for engine in ("host", "scan"):
    FleetTuner.from_grid(*grid, eval_runs=1, engine=engine, device="cpu",
                         ddpg_config=DDPGConfig(12, 2, updates_per_step=2)
                         ).run(2)
from repro_torch.core import FleetService
try:
    FleetService(chunk=2)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("FleetService without a card and without device= ran")
svc = FleetService(chunk=2, eval_runs=1, device="cpu",
                   ddpg_config=DDPGConfig(12, 2, updates_per_step=2))
sid = svc.request_join("seq_write", {{"throughput": 1.0}}, 0)
assert svc.advance(2) == [sid]
svc.request_leave(sid)
svc.advance(0)
assert len(svc.result(sid).history) == 2
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve
cfg = get_smoke_config("yi-9b")
try:
    serve(cfg, [[1, 2, 3]], 2)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("serve without a card and without device= ran")
assert serve(cfg, [[1] * 128], 2, device="cpu").tokens.shape == (1, 2)
assert serve(get_smoke_config("deepseek-moe-16b"), [[1] * 128], 2,
             device="cpu").tokens.shape == (1, 2)
assert serve(get_smoke_config("rwkv6-3b"), [[1] * 64], 2,
             device="cpu").tokens.shape == (1, 2)
from repro_torch.launch.train import main as train_main
try:
    train_main(["--smoke", "--steps", "1"])
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("training without a card and without --device ran")
assert train_main(["--smoke", "--steps", "1", "--device", "cpu"])["step"] == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result without a
    card, and alone in a directory without the repository."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], env=env,
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
