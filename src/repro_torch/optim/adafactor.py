"""Adafactor (``repro/optim/adafactor.py``), the optimizer of the 480B-class
MoE: not ported yet; it comes with the MoE slice."""

from __future__ import annotations


def adafactor(*args, **kwargs):
    raise NotImplementedError("adafactor is not ported yet: ROADMAP B4 "
                              "(the MoE slice)")
