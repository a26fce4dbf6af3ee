"""Every public name of the JAX package has a counterpart in the port, or a
row in ``NOT_PORTED`` with its reason.

The JAX package's sources are read with ``ast`` (no JAX module is
imported). A module's public names are its module-level functions,
classes and assigned names that do not start with ``_``, and its
re-exports: module-level ``from detectron_tpu... import`` in an
``__init__.py`` or on a line marked ``noqa: F401``. Each must exist under
the same name (or its ``RENAMED`` name) in the port's counterpart module
(``detectron_tpu_torch/<same path>``, or ``MODULE_MAP``'s), and each
``__init__`` re-export must import from the port's package, as ``from
detectron_tpu.ops import bbox_overlaps`` does from the JAX one.
"""

import ast
import importlib
from pathlib import Path

import pytest

import detectron_tpu_torch.native

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "detectron_tpu"
PORT = REPO / "detectron_tpu_torch"

# JAX modules whose functions the port keeps in another module: the Pallas
# kernels' files, whose ports sit beside their plain versions
MODULE_MAP = {
    "ops/nms_pallas.py": "ops/nms.py",
    "ops/roi_align_pallas.py": "ops/roi_align.py",
}

# (JAX module, name) -> the port's name for it in the counterpart module
RENAMED = {
    ("ops/nms_pallas.py", "nms_pallas"): "greedy_keep_cuda",
    ("ops/roi_align_pallas.py", "multilevel_roi_align_pallas"): "multilevel_roi_align_cuda",
    ("ops/roi_align_pallas.py", "multilevel_roi_align_pallas_bwd"):
        "multilevel_roi_align_bwd_cuda",
    ("ops/__init__.py", "multilevel_roi_align_pallas"): "multilevel_roi_align_cuda",
}

TPU_SCHEDULE = "a TPU schedule of a function the port computes in one way"
FLAX = "flax, optax or orbax plumbing"
# (JAX module, name) -> (kind, reason). A "computed by" row names the port's
# function that computes it, "module::name", which must exist.
NOT_PORTED = {
    ("layers/__init__.py", "anchor_target_single"):
        ("computed by", "layers/anchor_target.py::anchor_target"),
    # the package keeps the submodule under this name, as detectron_tpu.ops
    # keeps roi_align's
    ("layers/__init__.py", "anchor_target"):
        ("computed by", "layers/anchor_target.py::anchor_target"),
    ("layers/anchor_target.py", "anchor_target_single"):
        ("computed by", "layers/anchor_target.py::anchor_target"),
    ("layers/mask_target.py", "crop_gt_masks_to_rois"):
        ("computed by", "layers/mask_target.py::crop_gt_masks_batched"),
    ("layers/proposal_target.py", "sample_rois_single"):
        ("computed by", "layers/proposal_target.py::sample_rois"),
    ("models/fpn.py", "upsample2x_nearest"):
        ("computed by", "models/fpn.py::FPN"),  # F.interpolate(nearest) in the NCHW top-down
    ("models/rfcn.py", "build_rfcn"):
        ("computed by", "models/rfcn.py::RFCN"),  # the port's module takes the config
    ("train/state.py", "weight_decay_mask"):
        ("computed by", "train/state.py::decayed_parameters"),
    ("models/faster_rcnn.py", "resolve_nms_algo"): (TPU_SCHEDULE, "nms_algo: K1 on the card"),
    ("models/faster_rcnn.py", "use_fused_nms"): (TPU_SCHEDULE, "fused_nms: K1 on the card"),
    ("models/faster_rcnn.py", "use_fused_roi_align"):
        (TPU_SCHEDULE, "fused_roi_align: K2 and K3 on the card"),
    ("ops/nms.py", "NMS_TILE"): (TPU_SCHEDULE, "the tiled walk's 128 boxes"),
    ("ops/nms_pallas.py", "TILE"): (TPU_SCHEDULE, "the Pallas kernel's 128-box tiles"),
    ("ops/roi_align.py", "multilevel_roi_align_windowed"):
        (TPU_SCHEDULE, "windowed RoIAlign: K2, routed with the window's span (roi_max_span)"),
    ("ops/roi_align_pallas.py", "WINDOW"): (TPU_SCHEDULE, "the Pallas kernel's window"),
    ("ops/roi_align_pallas.py", "roi_align_fused"): (TPU_SCHEDULE, "K2 and K3"),
    ("ops/__init__.py", "roi_align_fused"): (TPU_SCHEDULE, "K2 and K3"),
    ("ops/roi_align_pallas.py", "roi_align_window_trainable"): (TPU_SCHEDULE, "K2 and K3"),
    ("parallel/mesh.py", "shardings"):
        (FLAX, "NamedShardings of a jax Mesh; the port's data parallelism has none"),
    ("parallel/__init__.py", "shardings"):
        (FLAX, "NamedShardings of a jax Mesh; the port's data parallelism has none"),
    ("train/checkpoint.py", "make_manager"): (FLAX, "orbax's CheckpointManager"),
    ("train/state.py", "apply_gradients"): (FLAX, "optax's update: the SGD step of train_step"),
    ("train/__init__.py", "apply_gradients"):
        (FLAX, "optax's update: the SGD step of train_step"),
    ("train/state.py", "trainable_mask"): (FLAX, "the parameters' requires_grad"),
    ("train/__init__.py", "trainable_mask"): (FLAX, "the parameters' requires_grad"),
    ("utils/torch_weights.py", "torch_key_to_flax_path"):
        (FLAX, "state-dict keys are the port's own names"),
    ("models/resnet.py", "StemConvS2D"):
        ("ROADMAP decision", "an exact re-layout of the plain stem, with the same parameter"),
}
KINDS = {"computed by", TPU_SCHEDULE, FLAX, "ROADMAP decision"}


def public_names(path: Path, reexports_only: bool = False) -> set:
    """The public names of one source file, as the module docstring says."""
    src = path.read_text()
    lines = src.splitlines()
    package = path.relative_to(REPO).parts[0]
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            marked = "noqa: F401" in lines[node.lineno - 1] or "noqa: F401" in lines[
                node.end_lineno - 1]
            if (node.module or "").startswith(package) and (
                    path.name == "__init__.py" or marked):
                names |= {a.asname or a.name for a in node.names}
        elif reexports_only:
            continue
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def port_names(rel: str) -> set:
    """Every module-level name of the port's module ``rel``, imports too."""
    path = PORT / rel
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
JAX_NAMES = {(m, n) for m in JAX_MODULES for n in public_names(JAX / m)}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart_or_a_reason(module):
    target = MODULE_MAP.get(module, module)
    assert (PORT / target).exists(), f"no port module for detectron_tpu/{module}"
    have = port_names(target)
    missing = []
    for name in sorted(public_names(JAX / module)):
        if (module, name) in NOT_PORTED:
            kind, reason = NOT_PORTED[(module, name)]
            assert kind in KINDS and reason
            assert RENAMED.get((module, name), name) not in have, (
                f"{module}::{name} is ported now: take its NOT_PORTED row out")
            if kind == "computed by":
                where, fn = reason.split("::")
                assert fn in port_names(where), f"{reason} does not exist"
            continue
        if RENAMED.get((module, name), name) not in have:
            missing.append(name)
    assert not missing, f"detectron_tpu/{module}: no counterpart in detectron_tpu_torch/" \
                        f"{target} and no reason for {missing}"


def test_tables_name_only_what_the_jax_package_has():
    """No row outlives the JAX name it is about."""
    assert set(NOT_PORTED) <= JAX_NAMES
    assert set(RENAMED) <= JAX_NAMES
    assert set(NOT_PORTED).isdisjoint(RENAMED)


@pytest.mark.parametrize("package", sorted(str(p.parent.relative_to(JAX))
                                           for p in JAX.rglob("__init__.py")
                                           if p.parent != JAX))
def test_init_reexports_import_from_the_port(package):
    """``from detectron_tpu_torch.<package> import <name>`` works for each
    re-export of ``detectron_tpu.<package>`` that the port has."""
    module = f"{package}/__init__.py"
    port = importlib.import_module(f"detectron_tpu_torch.{package.replace('/', '.')}")
    wanted = public_names(JAX / module, reexports_only=True)
    missing = [n for n in sorted(wanted) if (module, n) not in NOT_PORTED
               and not hasattr(port, RENAMED.get((module, n), n))]
    assert not missing, f"detectron_tpu_torch.{package} does not re-export {missing}"


def test_have_native_reports_whether_the_codec_loads(monkeypatch):
    assert detectron_tpu_torch.native.have_native()  # g++ builds it here

    def no_compiler():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(detectron_tpu_torch.native, "_lib", None)
    monkeypatch.setattr(detectron_tpu_torch.native, "build", no_compiler)
    assert not detectron_tpu_torch.native.have_native()
