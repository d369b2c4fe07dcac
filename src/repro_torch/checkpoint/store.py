"""Fault-tolerant checkpoints of trees of tensors (``repro/checkpoint/
store.py``): atomic writes, a CRC per tensor, keep-k pruning,
resume-latest.

Layout: ``<dir>/step_<N>/`` holding ``tensors.pt`` (``torch.save`` of a flat
dict of CPU tensors) and ``manifest.json``. A checkpoint is written to
``step_<N>.tmp-<pid>`` and renamed into place, so a crash mid-write never
corrupts the latest checkpoint. Both files are fsync'd before the rename
and the parent directory after it. Every tensor's bytes are CRC'd in the
manifest and verified on restore. With ``fallback=True`` a latest
checkpoint that fails to load or verify gives way to the newest verifiable
one.

A tree is nested dicts, tuples and NamedTuples of tensors (the params and
the optimizer state); a leaf's key is its path joined by ``/`` (dict keys,
tuple indices). The port writes and reads its own checkpoints; it does not
read the JAX package's. Restoring onto another device layout (the
reference's resharding) waits for the sharding slice (ROADMAP A11).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import zipfile
import zlib

import torch


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix="") -> dict:
    children = _children(tree)
    if children is None:
        return {prefix: tree}
    flat = {}
    for key, child in children:
        flat.update(_flatten(child, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def _crc(t: torch.Tensor) -> int:
    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return zlib.crc32(raw.numpy().tobytes())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(directory: str, step: int, tree, keep: int = 3,
                    extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    flat = {k: v.detach().cpu().contiguous() for k, v in
            _flatten(tree).items()}
    with open(os.path.join(tmp, "tensors.pt"), "wb") as f:
        torch.save(flat, f)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": int(step),
        "crc": {k: _crc(v) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    _fsync_dir(directory)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
    for name in os.listdir(directory):       # stale tmp dirs of crashed writers
        if ".tmp-" in name:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def list_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str):
    steps = list_steps(directory)
    return steps[-1] if steps else None


# everything a torn or corrupted step directory can throw while loading
_RESTORE_ERRORS = (OSError, ValueError, KeyError, EOFError, RuntimeError,
                   zipfile.BadZipFile, pickle.UnpicklingError,
                   json.JSONDecodeError)


def restore_checkpoint(directory: str, step: int | None = None,
                       verify: bool = True, fallback: bool = False) -> tuple:
    """Returns ``(step, flat dict of CPU tensors, extra)``. With
    ``fallback=True`` (and no ``step``) the keep-k history is walked newest
    to oldest past checkpoints that fail to load or verify."""
    if step is not None:
        return _restore_step(directory, step, verify)
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    if not fallback:
        return _restore_step(directory, steps[-1], verify)
    last_err = None
    for s in reversed(steps):
        try:
            return _restore_step(directory, s, verify)
        except _RESTORE_ERRORS as e:
            last_err = e
    raise IOError(f"no verifiable checkpoint among steps {steps} in "
                  f"{directory}") from last_err


def _restore_step(directory: str, step: int, verify: bool) -> tuple:
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = torch.load(os.path.join(path, "tensors.pt"), map_location="cpu",
                      weights_only=True)
    if verify:
        for k, v in flat.items():
            if _crc(v) != manifest["crc"][k]:
                raise IOError(f"checkpoint corruption detected in {k!r} "
                              f"({path})")
    return step, flat, manifest.get("extra", {})


def restore_into(template, flat: dict, prefix: str = ""):
    """The tree of ``template`` rebuilt from a flat dict, each tensor cast
    to its template leaf's dtype and placed on its device."""
    children = _children(template)
    if children is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        t = flat[prefix]
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"shape mismatch for {prefix!r}: checkpoint "
                             f"{tuple(t.shape)} vs template "
                             f"{tuple(template.shape)}")
        return t.to(device=template.device, dtype=template.dtype)
    built = [restore_into(child, flat, f"{prefix}/{key}" if prefix
                          else str(key)) for key, child in children]
    if isinstance(template, dict):
        return dict(zip(template.keys(), built))
    if hasattr(template, "_fields"):          # NamedTuple
        return type(template)(*built)
    return type(template)(built)
