"""Checkpoints of the port (the counterpart of
``openvoice_tpu/ckpt/native_io.py``).  Two tiers:

* **npz** (`save_npz` / `load_npz`): one file of flat dotted-path keys, the
  JAX package's format, read and written both ways (``api.py`` loads a
  converter's ``.npz`` through `load_npz`).  A ``None`` leaf is
  skipped, and a list with a gap comes back without it, as there.  The
  converter's weights cross as the JAX package's pytree
  (``ckpt/from_jax.py``): ``save_npz(path, synthesizer_to_jax(model))``
  writes what its ``load_npz`` + ``synthesizer_from_jax`` read, and
  `load_npz` + `synthesizer_from_jax` read what it writes.
* **checkpoint directories** (`save_checkpoint` / `load_checkpoint` /
  `latest_step`): ``torch.save`` of the models' and optimizers' state dicts
  and the step, one ``step_N/state.pt`` a step, or of a bare model's state
  dict.  A train state is anything with ``model``, ``opt`` and ``step``
  (``training/train.py::TrainState``), or with ``gen`` and ``disc`` states
  (``GanTrainState``), so this module needs nothing of the training layer.
  `convert_torch_checkpoint` writes a reference ``.pth``'s weights (weight
  norm folded, ``ckpt/torch_import.py``) as such a directory, which
  ``load_checkpoint(dir, template=<a Synthesizer>)`` reads back.  The JAX
  package keeps this tier in Orbax, which is its own and is not ported: the
  two tiers do not read each other.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
from torch import nn

STATE_FILE = "state.pt"


# ---------------------------------------------------------------------------
# Flat npz tier
# ---------------------------------------------------------------------------

def _leaf(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}.{i}"))
    elif tree is not None:
        out[prefix] = _leaf(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            # numeric order, gaps tolerated: a None leaf inside a list is
            # skipped by _flatten, leaving e.g. keys {0, 2}
            return [listify(node[k]) for k in sorted(keys, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_npz(path: str, tree: Any) -> None:
    """A pytree (dicts and lists of numpy arrays or tensors) → one ``.npz``
    of dotted-path keys."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_npz(path: str) -> Any:
    """An ``.npz`` of dotted-path keys → the pytree of numpy arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


# ---------------------------------------------------------------------------
# Training-state tier
# ---------------------------------------------------------------------------

def _is_gan(state: Any) -> bool:
    return hasattr(state, "gen") and hasattr(state, "disc")


def _is_train(state: Any) -> bool:
    return all(hasattr(state, name) for name in ("model", "opt", "step"))


def _payload(state: Any) -> Any:
    """What `save_checkpoint` writes: a train state's model and optimizer
    state dicts and its step (a GAN state's as ``gen`` and ``disc``); a bare
    model's state dict as ``model``; anything else as it is."""
    if _is_gan(state):
        return {"gen": _payload(state.gen), "disc": _payload(state.disc)}
    if _is_train(state):
        return {"model": state.model.state_dict(), "opt": state.opt.state_dict(), "step": state.step}
    if isinstance(state, nn.Module):
        return {"model": state.state_dict()}
    return state


def _restore(template: Any, payload: Any) -> Any:
    """`payload` loaded into the train state or model `template` in place
    (which is returned); anything else: the payload."""
    if _is_gan(template):
        _restore(template.gen, payload["gen"])
        _restore(template.disc, payload["disc"])
        return template
    if _is_train(template):
        template.model.load_state_dict(payload["model"], strict=True)
        template.opt.load_state_dict(payload["opt"])
        template.step = int(payload["step"])
        return template
    if isinstance(template, nn.Module):
        template.load_state_dict(payload["model"], strict=True)
        return template
    return payload


def save_checkpoint(directory: str, state: Any, step: int | None = None) -> str:
    """Write `state` under `directory` (``directory/step_N`` with a step);
    returns the written directory.  The file is replaced whole: a save cut
    short leaves the one before it."""
    path = os.path.abspath(directory)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_payload(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def load_checkpoint(directory: str, template: Any | None = None) -> Any:
    """Read what `save_checkpoint` wrote at `directory`.  With a `template`
    (a train state or a model of the same shapes) the weights, the
    optimizers' moments and the step are loaded into it, on its devices, and
    it is returned; without one, the raw payload (on the CPU)."""
    payload = torch.load(os.path.join(os.path.abspath(directory), STATE_FILE), map_location="cpu",
                         weights_only=True)
    return payload if template is None else _restore(template, payload)


def latest_step(directory: str) -> int | None:
    """Highest step_N subdirectory, for train resume."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name[5:]) for name in os.listdir(directory) if name.startswith("step_") and name[5:].isdigit()]
    return max(steps) if steps else None


def convert_torch_checkpoint(pth_path: str, out_dir: str, cfg) -> str:
    """One-time tool: a reference ``.pth`` → a checkpoint directory of the
    weight-norm-folded weights (`save_checkpoint` of the imported
    `Synthesizer`); returns the written path."""
    from openvoice_tpu_torch.ckpt.torch_import import load_torch_checkpoint

    model, report = load_torch_checkpoint(pth_path, cfg)
    path = save_checkpoint(out_dir, model)
    if report.get("unexpected"):
        print(f"[convert] {len(report['unexpected'])} unexpected keys ignored")
    return path
