from repro_torch.optim.adam import AdamHyper, adam_step, bias_corrections

__all__ = ["AdamHyper", "adam_step", "bias_corrections"]
