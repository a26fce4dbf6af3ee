"""Checkpoints of a training run: ``torch.save`` of ``{step, params,
optimizer}`` into ``<directory>/ckpt_<step>.pt``, and resume from the
latest one.

The port of ``detectron_tpu/train/checkpoint.py`` (orbax there): ``save``
writes one snapshot and keeps the newest ``max_to_keep``; ``restore`` loads
the latest snapshot into a train state and returns it unchanged when there
is none; ``restore_params`` loads the weights alone, for evaluation.
"""

from __future__ import annotations

import os
import re

import torch

from detectron_tpu_torch.train.state import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(directory)) if m)


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save(directory: str, state: TrainState, max_to_keep: int = 5) -> str:
    """Writes the snapshot of ``state.step`` (atomically: a temporary file,
    then a rename) and removes all but the newest ``max_to_keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{state.step}.pt")
    tmp = path + ".tmp"
    torch.save({"step": state.step, "params": state.params,
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    for step in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"ckpt_{step}.pt"))
    return path


def restore(directory: str, state: TrainState) -> TrainState:
    """Loads the latest snapshot in ``directory`` into ``state`` (weights,
    momentum buffers, step) and returns it."""
    step = latest_step(directory)
    if step is None:
        return state
    snap = torch.load(os.path.join(directory, f"ckpt_{step}.pt"),
                      map_location=state.detector.device, weights_only=True)
    state.detector.module.load_state_dict(snap["params"])
    state.optimizer.load_state_dict(snap["optimizer"])
    state.step = int(snap["step"])
    return state


def restore_params(directory: str, params: dict, device=None) -> tuple[dict, int | None]:
    """``(params, step)`` of the latest snapshot in ``directory``, its
    weights alone (the optimizer the training run used does not matter), or
    ``(params, None)`` unchanged when there is none."""
    step = latest_step(directory)
    if step is None:
        return params, None
    snap = torch.load(os.path.join(directory, f"ckpt_{step}.pt"), map_location=device,
                      weights_only=True)
    if set(snap["params"]) != set(params):
        raise KeyError(f"checkpoint {directory}/ckpt_{step}.pt holds other weights than the "
                       f"model: {sorted(set(snap['params']) ^ set(params))[:5]}")
    return snap["params"], int(snap["step"])
