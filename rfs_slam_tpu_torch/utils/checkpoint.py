"""Checkpoint / resume of filter state (port of the JAX package's
``utils/checkpoint.py``).

A snapshot is ``torch.save`` of a dict: the step index, the filter state as
a nested dict of CPU tensors (one level per state dataclass), and the state
of the run's ``torch.Generator`` (``get_state()``).  The JAX package keeps
its random key inside the filter state; the port draws from a generator, so
the generator travels beside the state.  Snapshots are written atomically
(a ``.tmp`` file, ``fsync``, ``os.replace``) and rotated ``keep`` deep.
:func:`restore` loads with ``weights_only=True`` and checks every leaf's
shape and dtype against a template state before it moves the leaf to the
template's device.
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_host(obj):
    """State dataclass -> nested dict of CPU tensors."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _to_host(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu()
        else:
            raise TypeError(f"checkpoint: field {f.name} is not a tensor")
    return out


def _from_host(template, data, where: str = "state"):
    """``template``'s dataclass tree with the leaves of ``data``, each
    checked against the template's shape and dtype and moved to its
    device."""
    kwargs = {}
    for f in dataclasses.fields(template):
        t, v = getattr(template, f.name), data[f.name]
        name = f"{where}.{f.name}"
        if dataclasses.is_dataclass(t):
            kwargs[f.name] = _from_host(t, v, name)
            continue
        if v.shape != t.shape or v.dtype != t.dtype:
            raise ValueError(f"checkpoint: {name} is {v.dtype}"
                             f"{list(v.shape)}, the template {t.dtype}"
                             f"{list(t.shape)}")
        kwargs[f.name] = v.to(t.device)
    return type(template)(**kwargs)


def save(ckpt_dir: str, step: int, state, gen: torch.Generator | None = None,
         keep: int = 3) -> str:
    """Write a snapshot of ``state`` (and ``gen``'s state) at ``step``
    atomically; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"step": int(step), "state": _to_host(state),
               "gen": None if gen is None else gen.get_state()}
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _rotate(ckpt_dir, keep)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    """Step index of the newest snapshot, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _CKPT_RE.match(n))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template_state, step: int | None = None,
            gen: torch.Generator | None = None):
    """Load the snapshot at ``step`` (the newest when None) into the
    structure, shapes, dtypes and device of ``template_state``; ``gen``,
    when given, takes the saved generator state.

    Returns ``(step, state)``.  Raises FileNotFoundError when there is no
    such snapshot and ValueError when a leaf differs from the template.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at step {step} in {ckpt_dir}")
    data = torch.load(path, map_location="cpu", weights_only=True)
    state = _from_host(template_state, data["state"])
    if gen is not None:
        if data["gen"] is None:
            raise ValueError(f"checkpoint: {path} holds no generator state")
        gen.set_state(data["gen"])
    return int(data["step"]), state


def _rotate(ckpt_dir: str, keep: int) -> None:
    entries = sorted(
        (int(m.group(1)), n) for n in os.listdir(ckpt_dir)
        if (m := _CKPT_RE.match(n)))
    for _, name in entries[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(ckpt_dir, name))
