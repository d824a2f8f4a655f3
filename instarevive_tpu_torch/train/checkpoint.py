"""Checkpoint IO (``instarevive_tpu/train/checkpoint.py``) in the port's own
format: one ``torch.save`` file per checkpoint path (a directory is made and
the file is ``state.pt`` inside it, so the paths the trainer prints look like
the JAX package's). Orbax checkpoints are not read.

A full checkpoint holds every ``TrainState`` (the module's state dict, the
optimizer state, the EMA, the step), any plain carry as it is, the random
generators' states (in place of the JAX key: one generator, or several by
name) and the global step, so that a resumed run continues bit for bit. The
legacy layout ``{"params", "ema"}`` restores the first state's weights only.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from instarevive_tpu_torch.train.state import TrainState

FILE = "state.pt"


def _file(path: str) -> str:
    return path if path.endswith((".pt", ".pth")) else os.path.join(path, FILE)


def save_checkpoint(path: str, tree: Any) -> None:
    """``torch.save`` through a temporary file, so a kill leaves no torn checkpoint."""
    target = _file(os.path.abspath(path))
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, target)


def load_checkpoint(path: str) -> Any:
    return torch.load(_file(os.path.abspath(path)), map_location="cpu", weights_only=True)


def _counts(tree):
    """The tree with its 0-dim integer tensors (the counts a device-gated
    step keeps on the card) as ints, as an ungated state holds them."""
    if isinstance(tree, torch.Tensor) and tree.ndim == 0 and not tree.is_floating_point():
        return int(tree)
    if isinstance(tree, dict):
        return {k: _counts(v) for k, v in tree.items()}
    return tree


def state_to_tree(s):
    if isinstance(s, TrainState):
        return {
            "step": int(s.step),
            "params": {k: v.detach() for k, v in s.module.state_dict().items()},
            "opt_state": _counts(s.opt_state),
            "ema": s.ema_state_dict(),
        }
    return s  # plain carry (or None)


def _copy_into(dst, src) -> Any:
    """Copy a saved optimizer-state tree into a live one of the same structure."""
    if isinstance(dst, torch.Tensor) and dst.ndim == 0 and not dst.is_floating_point():
        return int(src)  # a count the device kept: the restored state counts on the host again
    if isinstance(dst, torch.Tensor):
        dst.copy_(src if isinstance(src, torch.Tensor) else torch.from_numpy(np.array(src)))
        return dst
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"optimizer state keys differ: {sorted(dst)} vs {sorted(src)}")
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k])
        return dst
    if isinstance(dst, list):
        if len(dst) != len(src):
            raise ValueError(f"optimizer state lists differ in length: {len(dst)} vs {len(src)}")
        return [_copy_into(d, s) for d, s in zip(dst, src)]
    return src  # ints


def _tensors(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)) for k, v in sd.items()}


@torch.no_grad()
def load_state_tree(template, tree):
    """Load a ``state_to_tree`` tree (tensors or numpy arrays) into a live
    ``TrainState`` in place; a plain carry is returned as it is."""
    if not isinstance(template, TrainState):
        return tree
    template.module.load_state_dict(_tensors(tree["params"]), strict=True)
    template.opt_state = _copy_into(template.opt_state, tree["opt_state"])
    if template.ema_params is not None and tree["ema"] is not None:
        ema = _tensors(tree["ema"])
        for name, e in zip(template.names, template.ema_params):
            e.copy_(ema[name])
    template.step = int(tree["step"])
    return template


Generators = Union[None, torch.Generator, Mapping[str, torch.Generator]]


def _rng_state(generator: Generators):
    if generator is None or isinstance(generator, torch.Generator):
        return None if generator is None else generator.get_state()
    return {name: g.get_state() for name, g in generator.items()}


def _set_rng_state(generator: Generators, saved) -> None:
    """A saved single state goes to the single generator, or to the one named
    'step' (a checkpoint written before the degradation had generators)."""
    if generator is None or saved is None:
        return
    if isinstance(generator, torch.Generator):
        generator.set_state(saved["step"] if isinstance(saved, Mapping) else saved)
    elif isinstance(saved, Mapping):
        for name, g in generator.items():
            if name in saved:
                g.set_state(saved[name])
    elif "step" in generator:
        generator["step"].set_state(saved)


def save_train_state(path: str, states: Sequence, generator: Generators, step_i: int) -> None:
    """Full-fidelity training checkpoint: every state of ``states``, the
    state of the generator (or of each named generator) and the global step."""
    save_checkpoint(path, {
        "states": [state_to_tree(s) for s in states],
        "rng": _rng_state(generator),
        "step_i": int(step_i),
    })


def restore_train_state(path: str, states: Sequence, generator: Generators) -> Tuple[tuple, int]:
    """Restore a ``save_train_state`` checkpoint into freshly made states and
    the generator(s), in place; a legacy ``{"params", "ema"}`` checkpoint loads
    into the first state at step 0. Returns (states, step_i)."""
    saved = load_checkpoint(path)
    if "states" not in saved:
        if "params" not in saved:
            raise ValueError(f"{path} is neither a full train state nor a params/EMA checkpoint")
        lead = states[0]
        load_state_tree(lead, {"params": saved["params"], "ema": saved.get("ema"),
                               "opt_state": lead.opt_state, "step": lead.step})
        return tuple(states), 0
    if len(saved["states"]) != len(states):
        raise ValueError(f"{path} holds {len(saved['states'])} states, the run has {len(states)}")
    new_states = tuple(load_state_tree(s, t) for s, t in zip(states, saved["states"]))
    _set_rng_state(generator, saved["rng"])
    return new_states, int(saved["step_i"])


def load_null_embed(path: str) -> np.ndarray:
    """The cached T5 null-prompt embedding (.npy, .npz or a torch file), as
    an (L, C) f32 array."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
    else:
        t = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(t, Mapping):
            t = next(iter(t.values()))
        arr = t.detach().float().numpy()
    arr = np.asarray(arr, dtype=np.float32)
    while arr.ndim > 2:
        arr = arr[0]
    return arr
