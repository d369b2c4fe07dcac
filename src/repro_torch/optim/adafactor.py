"""Adafactor (``repro/optim/adafactor.py``), the optimizer of the 480B-class
MoE: not ported yet. The port serves the MoE family; MoE training comes
with ``gmm``'s gradient."""

from __future__ import annotations


def adafactor(*args, **kwargs):
    raise NotImplementedError("adafactor is not ported yet: ROADMAP A11e "
                              "(MoE training)")
