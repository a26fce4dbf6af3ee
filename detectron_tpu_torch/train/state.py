"""Train state: optimizer, learning-rate schedule, one training step.

The port of ``detectron_tpu/train/state.py`` and of the train step of
``detectron_tpu/parallel/mesh.py::make_train_step`` on one device:

* SGD with momentum (``train.momentum``); PyTorch's momentum buffer is
  optax's ``trace`` (``buf = g + m * buf``, ``p -= lr * buf``);
* weight decay ``train.weight_decay`` on the conv, deconv and linear
  weights only (the flax ``kernel`` leaves), added to the gradient before
  the momentum, as ``optax.add_decayed_weights`` does;
* frozen parameters (``requires_grad=False``: the stem and the stages
  ``<= model.frozen_stages``) stay out of the optimizer;
* a trainable parameter that the loss does not reach (R-FCN's res5 on the
  C4 trunk) gets a zero gradient, as under optax, so that weight decay and
  momentum still move it;
* with ``train.grad_clip_norm > 0``, optax's ``clip_by_global_norm`` over
  the trainable gradients: ``g * max_norm / norm`` when ``norm >=
  max_norm``;
* a linear warmup from ``base_lr * warmup_factor``, then step decay.

The state is updated in place: the detector's module holds the
parameters, the optimizer its momentum buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from detectron_tpu_torch.models.zoo import Detector
from detectron_tpu_torch.utils.spans import span


def warmup_step_decay_schedule(cfg):
    """``step -> learning rate``: optax's ``linear_schedule`` from
    ``base_lr * warmup_factor`` to ``base_lr`` over ``warmup_steps``, then
    ``piecewise_constant_schedule`` scaled by ``lr_decay_factor`` at each
    of ``lr_decay_steps``."""
    base = cfg.train.base_lr
    start = base * cfg.train.warmup_factor
    warmup_steps = cfg.train.warmup_steps
    span = max(warmup_steps, 1)
    boundaries = sorted(cfg.train.lr_decay_steps)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), span) / span
            return (start - base) * frac + base
        lr = base
        for boundary in boundaries:
            if step >= boundary:
                lr *= cfg.train.lr_decay_factor
        return lr

    return schedule


DECAYED_LAYERS = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)


def decayed_parameters(module: torch.nn.Module) -> set[str]:
    """Names of the weights that weight decay takes: the conv, deconv and
    linear weights (the flax ``kernel`` leaves of JAX's
    ``weight_decay_mask``), not biases or GroupNorm's scale."""
    return {f"{name}.weight" if name else "weight" for name, m in module.named_modules()
            if isinstance(m, DECAYED_LAYERS)}


def make_optimizer(cfg, module: torch.nn.Module) -> torch.optim.SGD:
    """SGD over the trainable parameters of ``module``: one group of
    :func:`decayed_parameters` with decay, one of the rest without."""
    decayed = decayed_parameters(module)
    decay, no_decay = [], []
    for name, param in module.named_parameters():
        if param.requires_grad:
            (decay if name in decayed else no_decay).append(param)
    return torch.optim.SGD(
        [{"params": decay, "weight_decay": cfg.train.weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=cfg.train.base_lr, momentum=cfg.train.momentum)


@dataclass
class TrainState:
    """What one training run carries from step to step."""

    detector: Detector
    optimizer: torch.optim.SGD
    schedule: Callable[[int], float]
    step: int = 0

    @property
    def params(self) -> dict:
        return self.detector.module.state_dict()


def create_train_state(cfg, detector: Detector, params: dict | None = None) -> TrainState:
    """A state at step 0; ``params`` (a state dict), if given, is loaded
    into the detector's module first."""
    if params is not None:
        detector.module.load_state_dict(params)
    return TrainState(detector, make_optimizer(cfg, detector.module),
                      warmup_step_decay_schedule(cfg))


def step_generator(cfg, step: int, device) -> torch.Generator:
    """The sampling draws' generator of one step, seeded from
    ``train.seed`` and the step (``jax.random.fold_in(key, step)`` in the
    JAX package)."""
    return torch.Generator(device=device).manual_seed(
        (cfg.train.seed + 1) * 1_000_003 + step)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    every gradient becomes ``g / norm * max_norm`` when the global norm is
    at least ``max_norm``. Returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    divisor = torch.where(clip, norm, one)
    factor = torch.where(clip, torch.full_like(norm, max_norm), one)
    for g in grads:
        g.div_(divisor).mul_(factor)
    return norm


def train_step(state: TrainState, batch, draws=None, mark=None, reduce_grads=None) -> dict:
    """One step: the loss and its gradient, the optimizer's update at the
    schedule's rate for ``state.step``, then ``state.step += 1``.

    ``draws``: the ``TrainDraws`` to sample with (Faster / Mask R-CNN and
    R-FCN; sized to their RPN's anchors), or None for a generator seeded
    from ``train.seed`` and the step. The step is a span
    (``utils/spans.py``), and so is each of its stages. ``mark``: None, or
    a callable given each stage's name once its work is issued: the
    forward's stages
    (``faster_rcnn_train_forward``, ``retinanet_train_forward``,
    ``rfcn_train_forward``), then
    ``"backward"`` (with ``reduce_grads``, ``"gradient all-reduce"``) and
    ``"optimizer"``. ``reduce_grads``: None, or a
    callable given the list of trainable gradients (every one filled)
    before the clip; the data-parallel step sums them across ranks there
    (``parallel.make_train_step``). Returns the loss dict with
    ``loss_total``, as detached tensors on the device.
    """
    with span("train_step"):
        det = state.detector
        cfg = det.cfg
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        if draws is None:
            draws = step_generator(cfg, state.step, det.device)
        state.optimizer.zero_grad(set_to_none=True)
        total, loss_dict = det.loss_fn(None, batch, draws, mark=mark)
        with span("backward", mark):
            total.backward()
            params = [p for group in state.optimizer.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if reduce_grads is not None:
            with span("gradient all-reduce", mark):
                reduce_grads([p.grad for p in params])
        with span("optimizer", mark):
            if cfg.train.grad_clip_norm > 0:
                clip_by_global_norm([p.grad for p in params], cfg.train.grad_clip_norm)
            state.optimizer.step()
        state.step += 1
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics["loss_total"] = total.detach()
    return metrics
