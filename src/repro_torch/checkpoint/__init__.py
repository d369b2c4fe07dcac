from repro_torch.checkpoint.store import (
    latest_step, list_steps, restore_checkpoint, restore_into,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps", "restore_into"]
