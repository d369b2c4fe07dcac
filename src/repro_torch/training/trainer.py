"""The training loop (``repro/training/trainer.py``): checkpointed,
preemption-safe, straggler-aware.

  * checkpoint/restart: atomic keep-k checkpoints every N steps
    (``checkpoint/store.py``); resume picks the latest intact checkpoint,
    and the deterministic data pipeline's skip-ahead regenerates exactly
    the batches a never-failed run would have seen.
  * preemption: SIGTERM/SIGINT sets a flag; the loop checkpoints at the
    next step boundary and exits cleanly.
  * stragglers: a wall-clock watchdog tracks the rolling median step time;
    a step over ``watchdog_factor`` x the median is counted, and after
    ``watchdog_limit`` consecutive slow steps the trainer checkpoints and
    raises ``StragglerAbort`` for the launcher to restart the job.

The port's train step updates the parameters and optimizer state in place
and returns them (``training/steps.py``); the loop is the reference's. A
step's metrics are read back as Python floats, which waits for the card, so
``seconds`` is the step's wall time on the card.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Any, Callable, Optional

from repro_torch import checkpoint as ckpt


class StragglerAbort(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    log_every: int = 10
    watchdog_factor: float = 3.0     # slow-step threshold (x median)
    watchdog_limit: int = 3          # consecutive slow steps before abort
    watchdog_warmup: int = 5         # steps before the watchdog arms


class Trainer:
    def __init__(self, train_step: Callable, pipeline, params, opt_state,
                 tcfg: TrainerConfig, to_batch: Optional[Callable] = None):
        self.train_step = train_step
        self.pipeline = pipeline
        self.params = params
        self.opt_state = opt_state
        self.tcfg = tcfg
        self.to_batch = to_batch or (lambda b: b)
        self.step = 0
        self.metrics_log: list = []
        self._step_times: list = []
        self._slow_streak = 0
        self._preempted = False
        self._orig_handlers: dict = {}

    # -- preemption -------------------------------------------------------

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig_handlers[sig] = signal.signal(sig, handler)
            except ValueError:       # non-main thread (tests)
                pass

    def _restore_signal_handlers(self):
        for sig, h in self._orig_handlers.items():
            signal.signal(sig, h)

    # -- checkpointing ----------------------------------------------------

    def state_tree(self) -> dict:
        return {"params": self.params, "opt_state": self.opt_state}

    def save(self) -> Optional[str]:
        if not self.tcfg.checkpoint_dir:
            return None
        return ckpt.save_checkpoint(
            self.tcfg.checkpoint_dir, self.step, self.state_tree(),
            keep=self.tcfg.keep_checkpoints,
            extra={"metrics_tail": self.metrics_log[-1]
                   if self.metrics_log else {}})

    def try_resume(self) -> bool:
        if not self.tcfg.checkpoint_dir:
            return False
        latest = ckpt.latest_step(self.tcfg.checkpoint_dir)
        if latest is None:
            return False
        step, flat, _ = ckpt.restore_checkpoint(self.tcfg.checkpoint_dir,
                                                latest)
        restored = ckpt.restore_into(self.state_tree(), flat)
        self.params = restored["params"]
        self.opt_state = restored["opt_state"]
        self.step = step
        return True

    # -- watchdog ---------------------------------------------------------

    def _watchdog(self, dt: float) -> None:
        self._step_times.append(dt)
        if len(self._step_times) <= self.tcfg.watchdog_warmup:
            return
        median = statistics.median(self._step_times[:-1][-50:])
        if dt > self.tcfg.watchdog_factor * max(median, 1e-9):
            self._slow_streak += 1
            if self._slow_streak >= self.tcfg.watchdog_limit:
                self.save()
                raise StragglerAbort(
                    f"step {self.step}: {self._slow_streak} consecutive "
                    f"steps > {self.tcfg.watchdog_factor}x median "
                    f"({median:.3f}s) — checkpointed; restart excluding "
                    f"the straggling host")
        else:
            self._slow_streak = 0

    # -- main loop ----------------------------------------------------------

    def run(self) -> dict:
        self._install_signal_handlers()
        try:
            while self.step < self.tcfg.total_steps:
                t0 = time.perf_counter()
                batch = self.to_batch(self.pipeline.batch(self.step))
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.step += 1
                metrics.update(step=self.step, seconds=dt)
                self.metrics_log.append(metrics)
                if self.step % self.tcfg.log_every == 0:
                    print(f"step {self.step}: loss={metrics['loss']:.4f} "
                          f"grad_norm={metrics['grad_norm']:.3f} "
                          f"({dt:.3f}s)", flush=True)
                if (self.tcfg.checkpoint_dir
                        and self.step % self.tcfg.checkpoint_every == 0):
                    self.save()
                if self._preempted:
                    self.save()
                    print(f"preempted at step {self.step}; checkpointed",
                          flush=True)
                    break
                self._watchdog(dt)
            else:
                if self.tcfg.checkpoint_dir:
                    self.save()
            return {"step": self.step, "metrics": self.metrics_log,
                    "preempted": self._preempted}
        finally:
            self._restore_signal_handlers()
