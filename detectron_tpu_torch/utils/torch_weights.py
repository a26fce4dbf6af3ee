"""Pretrained weights from torch state dicts: ``model.weights``.

The port of ``detectron_tpu/utils/torch_weights.py``, mapped straight onto
the port's own state-dict names. The reference fine-tunes from a
torchvision ResNet (a backbone dict); a full-detector dict (any RPN, FPN
or head key) replaces every part it holds. Both come as a ``.pth`` /
``.pt`` file (``torch.save``) or a numpy ``.npz`` with the same keys.

Backbone keys (torchvision -> the port, under ``backbone.``)::

  conv1.weight                   -> conv1.weight
  bn1.{weight,bias,running_*}    -> bn1.{...}
  layerL.B.convN.weight          -> layerL.B.convN.weight
  layerL.B.bnN.*                 -> layerL.B.bnN.*
  layerL.B.downsample.0.weight   -> layerL.B.downsample_conv.weight
  layerL.B.downsample.1.*        -> layerL.B.downsample_bn.*

(``fc.*`` and ``num_batches_tracked`` are skipped). Detector keys follow
``_DETECTOR_RULES``, which accept the port's names and the
Detectron / py-faster-rcnn lineage's (``fc6``/``fc7``, ``mask_fcn1..4``,
``conv5_mask``, ``mask_fcn_logits``, ``rpn_cls_score``, ``fpn_inner`` /
``fpn_output``). Layouts, where the JAX module converts to flax's:

* conv weights stay OIHW and linear weights ``(out, in)``;
* ``fc1`` permutes its input from torch's CHW flatten of the pooled RoI
  features to the HWC flatten the port (as JAX) uses;
* a ``ConvTranspose2d`` weight goes in as it is (the JAX import flips it
  into flax's correlation, and ``utils.weights.from_jax_params`` flips it
  back);
* a ``2A``-channel softmax RPN classifier (background first) becomes the
  ``A``-channel sigmoid one as ``fg - bg`` (the same posterior), and a
  ``K+1``-channel mask predictor drops its background channel 0, both on
  shape evidence only.

A key that no rule and no backbone pattern takes raises ``KeyError``, as
does a converted key the model lacks; a shape that does not fit raises
``ValueError``. R-FCN's and RetinaNet's head keys are not in the rules, so
a full R-FCN or RetinaNet dict raises, as in the JAX package.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BN_KEYS = {"weight", "bias", "running_mean", "running_var"}


def _to_numpy(t):
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def torch_key_to_port_key(key: str) -> str | None:
    """A torchvision ResNet key -> the port's key under ``backbone.``, or
    None for a skipped key (``fc``, ``num_batches_tracked``). The
    counterpart of the JAX module's ``torch_key_to_flax_path``."""
    if key.startswith("fc.") or key.endswith("num_batches_tracked"):
        return None
    if key == "conv1.weight":
        return key
    m = re.fullmatch(r"bn1\.(\w+)", key)
    if m and m.group(1) in _BN_KEYS:
        return key
    m = re.fullmatch(r"layer(\d)\.(\d+)\.conv(\d)\.weight", key)
    if m:
        return key
    m = re.fullmatch(r"layer(\d)\.(\d+)\.bn(\d)\.(\w+)", key)
    if m and m.group(4) in _BN_KEYS:
        return key
    m = re.fullmatch(r"layer(\d)\.(\d+)\.downsample\.0\.weight", key)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}.downsample_conv.weight"
    m = re.fullmatch(r"layer(\d)\.(\d+)\.downsample\.1\.(\w+)", key)
    if m and m.group(3) in _BN_KEYS:
        return f"layer{m.group(1)}.{m.group(2)}.downsample_bn.{m.group(3)}"
    raise KeyError(f"unrecognized torchvision resnet key: {key}")


def convert_resnet_state_dict(state_dict: dict) -> dict:
    """torch state dict -> ``{port key under backbone.: float32 array}``."""
    out = {}
    for key, value in state_dict.items():
        name = torch_key_to_port_key(key)
        if name is not None:
            out[name] = _to_numpy(value).astype(np.float32)
    return out


def _replace(params: dict, converted: dict, adapt=None) -> dict:
    """A copy of ``params`` with ``converted``'s entries in place, each a
    float32 tensor on its parameter's device; ``adapt(key, arr, want)``, if
    given, may reshape an entry on shape evidence first."""
    out = dict(params)
    for key, arr in converted.items():
        if key not in out:
            raise KeyError(f"param {key} not found in model")
        want = tuple(out[key].shape)
        if adapt is not None and arr.shape != want:
            arr = adapt(key, arr, want)
        if arr.shape != want:
            raise ValueError(f"shape mismatch at {key}: model {want} vs torch {arr.shape}")
        out[key] = torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float32,
                                   device=out[key].device)
    if not converted:
        raise ValueError("no weights loaded")
    return out


def load_resnet_backbone(params: dict, state_dict: dict,
                         backbone_name: str = "backbone") -> dict:
    """A copy of the state dict ``params`` with its backbone replaced by
    the converted torchvision weights; keys and shapes are checked."""
    converted = {f"{backbone_name}.{k}": v
                 for k, v in convert_resnet_state_dict(state_dict).items()}
    return _replace(params, converted)


# (regex over torch keys) -> (the port's key, kind)
_DETECTOR_RULES = [
    # FPN: lateral{l}/smooth{l}/p6/p7; Detectron-style fpn_inner/fpn_output
    # aliases map onto the same modules
    (re.compile(r"fpn\.(lateral|smooth)(\d)\.(weight|bias)"),
     lambda m: f"fpn.{m.group(1)}{m.group(2)}.{m.group(3)}", "conv"),
    (re.compile(r"(?:fpn\.)?fpn_inner(\d)\.(weight|bias)"),
     lambda m: f"fpn.lateral{m.group(1)}.{m.group(2)}", "conv"),
    (re.compile(r"(?:fpn\.)?fpn_output(\d)\.(weight|bias)"),
     lambda m: f"fpn.smooth{m.group(1)}.{m.group(2)}", "conv"),
    (re.compile(r"fpn\.(p[67])\.(weight|bias)"),
     lambda m: f"fpn.{m.group(1)}.{m.group(2)}", "conv"),
    # RPN head (rpn.-prefixed or py-faster-rcnn-style flat rpn_* names)
    (re.compile(r"(?:rpn\.conv|rpn_conv)\.(weight|bias)"),
     lambda m: f"rpn_head.conv.{m.group(1)}", "conv"),
    (re.compile(r"(?:rpn\.(?:cls_score|objectness)|rpn_cls_score)\.(weight|bias)"),
     lambda m: f"rpn_head.objectness.{m.group(1)}", "rpn_cls"),
    (re.compile(r"(?:rpn\.(?:bbox_pred|deltas)|rpn_bbox_pred)\.(weight|bias)"),
     lambda m: f"rpn_head.deltas.{m.group(1)}", "conv"),
    # box head (fc6/fc7 are the lineage names of the two FCs)
    (re.compile(r"(?:box_head\.)?fc[16]\.(weight|bias)"),
     lambda m: f"box_head.fc1.{m.group(1)}", "fc1"),
    (re.compile(r"(?:box_head\.)?fc[27]\.(weight|bias)"),
     lambda m: f"box_head.fc2.{m.group(1)}", "linear"),
    (re.compile(r"(?:box_head\.)?cls_score\.(weight|bias)"),
     lambda m: f"box_head.cls_score.{m.group(1)}", "linear"),
    (re.compile(r"(?:box_head\.)?bbox_pred\.(weight|bias)"),
     lambda m: f"box_head.bbox_pred.{m.group(1)}", "linear"),
    # mask head: the port's conv0-3 (0-based) vs the lineage's mask_fcn1-4
    (re.compile(r"mask_head\.conv(\d)\.(weight|bias)"),
     lambda m: f"mask_head.conv{m.group(1)}.{m.group(2)}", "conv"),
    (re.compile(r"(?:mask_head\.)?mask_fcn(\d)\.(weight|bias)"),
     lambda m: f"mask_head.conv{int(m.group(1)) - 1}.{m.group(2)}", "conv"),
    (re.compile(r"(?:mask_head\.)?(?:deconv|conv5_mask)\.(weight|bias)"),
     lambda m: f"mask_head.deconv.{m.group(1)}", "deconv"),
    (re.compile(r"(?:mask_head\.)?(?:mask_logits|mask_fcn_logits)\.(weight|bias)"),
     lambda m: f"mask_head.mask_logits.{m.group(1)}", "mask_logits"),
]

_BACKBONE_PREFIX = re.compile(r"(?:resnet\.|backbone\.)?(.*)")


def convert_detector_state_dict(state_dict: dict, pooled_hw: tuple = (7, 7)) -> dict:
    """A full-detector torch state dict -> ``{port key: float32 array}``.

    Backbone keys (bare, ``resnet.``- or ``backbone.``-prefixed) go under
    ``backbone.``; head keys follow ``_DETECTOR_RULES``. ``pooled_hw`` is the
    RoI grid the source's fc1 was trained on (to permute its CHW flatten
    to the HWC one)."""
    out = {}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        arr = _to_numpy(value).astype(np.float32)
        for rx, to_key, kind in _DETECTOR_RULES:
            m = rx.fullmatch(key)
            if m:
                name = to_key(m)
                if kind == "fc1" and name.endswith(".weight"):
                    arr = _permute_fc1(arr, pooled_hw)
                out[name] = arr
                break
        else:
            name = torch_key_to_port_key(_BACKBONE_PREFIX.fullmatch(key).group(1))
            if name is not None:
                out[f"backbone.{name}"] = arr
    return out


def _fg_minus_bg(arr, axis):
    """``2A``-channel bg/fg RPN softmax parameters (bg first) -> ``A``
    sigmoid logits: ``softmax([bg, fg])[fg] == sigmoid(fg - bg)``, so the
    imported sigmoid head gives the source's objectness posterior."""
    bg, fg = np.split(arr, 2, axis=axis)
    return fg - bg


def _permute_fc1(w, pooled_hw):
    """fc1 weight ``(out, C*H*W)`` with torch's CHW flatten -> HWC flatten."""
    h, p_w = pooled_hw
    o, i = w.shape
    c = i // (h * p_w)
    if c * h * p_w != i:
        raise ValueError(f"fc1 in-dim {i} not divisible by pooled {h}x{p_w}")
    return w.reshape(o, c, h, p_w).transpose(0, 2, 3, 1).reshape(o, i)


def _adapt_channels(key: str, arr: np.ndarray, want: tuple) -> np.ndarray:
    """The channel-count adapters, on shape evidence only (the output
    channels are axis 0 of a weight and of a bias)."""
    if key.startswith("rpn_head.objectness.") and arr.shape[0] == 2 * want[0]:
        return _fg_minus_bg(arr, axis=0)  # a 2A bg/fg softmax source
    if key.startswith("mask_head.mask_logits.") and arr.shape[0] == want[0] + 1:
        return arr[1:]  # the source's unused leading background channel
    return arr


def load_detector(params: dict, state_dict: dict, pooled_hw: tuple = (7, 7)) -> dict:
    """A copy of the state dict ``params`` with every part the full-detector
    ``state_dict`` holds replaced; any mismatch the adapters do not take
    raises."""
    return _replace(params, convert_detector_state_dict(state_dict, pooled_hw=pooled_hw),
                    _adapt_channels)


_DETECTOR_KEY = re.compile(
    r"(rpn[._]|box_head\.|mask_head\.|fpn\.|fpn_inner|fpn_output|fc[67]\.|"
    r"cls_score\.|bbox_pred\.|mask_fcn)")


def maybe_load_pretrained(cfg, params: dict) -> dict:
    """The drivers' entry point: if ``cfg.model.weights`` names a torch
    ``.pth`` (or numpy ``.npz``) state dict, ``params`` (a state dict) with
    the parts it holds replaced, else ``params`` as it is. A backbone-only
    dict replaces the backbone; a full-detector dict (any RPN, head or FPN
    key) everything it holds."""
    path = cfg.model.get("weights", "")
    if not path:
        return params
    if path.endswith(".npz"):
        with np.load(path) as npz:
            sd = dict(npz)
    else:
        sd = load_pth(path)
    if any(_DETECTOR_KEY.match(k) for k in sd):
        p = cfg.roi.get("pool_size", 7)
        return load_detector(params, sd, pooled_hw=(p, p))
    return load_resnet_backbone(params, sd)


def load_pth(path: str) -> dict:
    """A ``.pth`` / ``.pt`` state dict (``state_dict`` / ``model`` wrappers
    unwrapped, ``module.`` prefixes stripped)."""
    d = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(d, dict) and wrapper in d and isinstance(d[wrapper], dict):
            d = d[wrapper]
    return {k.replace("module.", ""): v for k, v in d.items()}
