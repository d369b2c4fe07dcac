"""End-to-end training entry point (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    python -m repro_torch.launch.train --arch phi4-mini-3.8b --steps 4 \\
        --global-batch 2 --seq 2048 --remat full

Random weights (``init_params`` from ``--seed``), the deterministic token
pipeline, ``make_optimizer``'s AdamW, the global-norm clip at 1.0, and the
``Trainer`` loop with checkpoints, preemption and the straggler watchdog.
On the card, a sequence length that is a multiple of 128 runs attention
through the flash kernels (forward, and the dq and dk/dv backward). The
port trains on one device: more than one, and ``--compress-grads``, raise
naming their ROADMAP rows.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs, optim
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import init_params, model_defs
from repro_torch.models.base import ArchConfig
from repro_torch.training import TrainConfig, Trainer, TrainerConfig, \
    make_train_step


def make_optimizer(cfg: ArchConfig) -> optim.GradientTransformation:
    """AdamW for <= 72B-class models; Adafactor for the 480B-class MoE (a
    copy of ``repro/launch/cells.py::make_optimizer``)."""
    if cfg.name.startswith("arctic"):
        return optim.adafactor(1e-4)
    return optim.adamw(3e-4, weight_decay=0.1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="yi-9b", choices=configs.ARCH_NAMES)
    p.add_argument("--smoke", action="store_true",
                   help="the few-layer, narrow config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--remat", default="none", help="none | full")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--lr", type=float, default=3e-4,
                   help="kept for the reference's interface: as there, "
                        "make_optimizer sets the rate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compress-grads", type=float, default=0.0,
                   help="top-k gradient compression (not ported)")
    p.add_argument("--devices", type=int, default=1,
                   help="devices to train on (the port runs one)")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    if args.compress_grads:
        raise NotImplementedError("--compress-grads "
                                  "(training/compression.py) is not ported "
                                  "yet: ROADMAP A11")
    if args.devices > 1:
        raise NotImplementedError("training on more than one device "
                                  "(sharding, launch/mesh.py) is not ported "
                                  "yet: ROADMAP A11")
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    device = resolve_device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_defs(cfg), generator, device)
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)
    step = make_train_step(cfg, tx, TrainConfig(
        microbatches=args.microbatches, remat=args.remat))
    pipeline = TokenPipeline(vocab_size=cfg.vocab_size,
                             global_batch=args.global_batch,
                             seq_len=args.seq, seed=args.seed)

    def to_batch(b):
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    trainer = Trainer(step, pipeline, params, opt_state,
                      TrainerConfig(total_steps=args.steps,
                                    checkpoint_every=args.checkpoint_every,
                                    checkpoint_dir=args.checkpoint_dir,
                                    log_every=1),
                      to_batch=to_batch)
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")
    out = trainer.run()
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"done: {out['step']} steps on {device}; loss {losses[0]:.4f} "
              f"-> {losses[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
