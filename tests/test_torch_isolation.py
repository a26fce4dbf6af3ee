"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points default to the card and refuse to fall back to
the CPU, its kernel wrappers take the plain path only for CPU tensors, and
a failed kernel build raises."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_collections", "yaml",
             "detectron_tpu")


def port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "detectron_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_names(path):
    """Every module an import statement or an import_module/__import__ call
    with a literal name mentions, at any depth of the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(arg, ast.Constant):
                yield str(arg.value)


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = [n for n in imported_names(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/mesh.py",
                                    "utils/metrics.py", "utils/timer.py"])
def test_parallel_and_logging_modules_are_checked(module):
    """The data-parallel and logging modules are among the files checked
    above, and import nothing forbidden."""
    path = os.path.join(REPO, "detectron_tpu_torch", module)
    assert path in port_files()
    assert not [n for n in imported_names(path) if n.split(".")[0] in FORBIDDEN]


def test_import_leaves_jax_out():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import detectron_tpu_torch
        for m in pkgutil.walk_packages(detectron_tpu_torch.__path__, "detectron_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(n for n in sys.modules if n.split(".")[0] in %r)
        print(len([n for n in sys.modules if n.startswith("detectron_tpu_torch.")]))
        assert not bad, bad
    """ % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module imported


def test_build_detector_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(None, ["model.name=mask_rcnn"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_rfcn_builds_and_defaults_to_cuda(monkeypatch):
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.rfcn import RFCN
    from detectron_tpu_torch.models.zoo import build_detector

    cfg = get_config(None, ["model.name=rfcn"])
    det = build_detector(cfg, device="cpu")
    assert isinstance(det.module, RFCN) and det.device == torch.device("cpu")
    assert det.is_rfcn and not det.is_two_stage
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg)


def test_retinanet_builds_and_defaults_to_cuda(monkeypatch):
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.retinanet import RetinaNet
    from detectron_tpu_torch.models.zoo import build_detector

    cfg = get_config(None, ["model.name=retinanet"])
    det = build_detector(cfg, device="cpu")
    assert isinstance(det.module, RetinaNet) and det.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg)


@pytest.mark.parametrize("override", ["model.norm=gn"])
def test_unported_variants_raise(override):
    """The last variant that raised, GroupNorm, is ported: it builds, and no
    module of the port raises ``NotImplementedError``; a norm that neither
    package has raises."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.resnet import GroupNorm
    from detectron_tpu_torch.models.zoo import build_detector

    det = build_detector(get_config(None, ["model.name=mask_rcnn", override]), device="cpu")
    assert isinstance(det.module.backbone.gn1, GroupNorm)
    for path in port_files():
        assert "NotImplementedError" not in open(path).read(), path
    with pytest.raises(ValueError, match="model.norm"):
        build_detector(get_config(None, ["model.name=mask_rcnn", "model.norm=sync_bn"]),
                       device="cpu")


@pytest.mark.parametrize("name", ["rfcn", "mask_rcnn"])
def test_dilate_c5_builds(name):
    """``model.dilate_c5=true`` builds: R-FCN's res5 keeps stride 16 with
    every 3x3 dilated by 2; the FPN detectors do not read the key (as in
    the JAX package), so their res5 keeps stride 2."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector

    det = build_detector(get_config(None, [f"model.name={name}", "model.dilate_c5=true"]),
                         device="cpu")
    layer4 = det.module.backbone.layer4
    dilated = name == "rfcn"
    assert [b.conv2.dilation for b in layer4] == [(2, 2) if dilated else (1, 1)] * 3
    assert layer4[0].conv2.stride == layer4[0].downsample_conv.stride == (
        (1, 1) if dilated else (2, 2))


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    from detectron_tpu_torch.ops import nms, roi_align

    nms.greedy_keep_cuda.launches = 0
    roi_align.multilevel_roi_align_cuda.launches = 0
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(3, 40, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + 5 + torch.rand(3, 40, 2, generator=g) * 40], -1)
    scores = torch.rand(3, 40, generator=g)
    idx, ok = nms.nms_padded_batched(boxes, scores, None, 0.5, 10)
    assert idx.shape == (3, 10) and ok.any()
    feats = [torch.randn(1, 16 >> i, 16 >> i, 8, generator=g) for i in range(4)]
    rois = torch.tensor([[[0.0, 0.0, 40.0, 30.0], [10.0, 5.0, 60.0, 64.0]]])
    out = roi_align.multilevel_roi_align(feats, rois, (4, 8, 16, 32), 7)
    assert out.shape == (1, 2, 7, 7, 8)
    assert nms.greedy_keep_cuda.launches == 0
    assert roi_align.multilevel_roi_align_cuda.launches == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    from detectron_tpu_torch.ops import nms, roi_align

    with pytest.raises(ValueError):
        nms.greedy_keep_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool), 0.5)
    feats = [torch.zeros(1, 8, 8, 4)]
    rois = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError):
        roi_align.multilevel_roi_align_cuda(feats, rois, torch.zeros(1, 1, dtype=torch.int32),
                                            (4,))
    # bf16 features are taken (K2's bf16 instance), and refused here for
    # lying on the CPU, not for their dtype
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.multilevel_roi_align_cuda([f.bfloat16() for f in feats], rois,
                                            torch.zeros(1, 1, dtype=torch.int32), (4,))


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    from detectron_tpu_torch import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build(["broken"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    from detectron_tpu_torch import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("a")
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("b")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_builds_started_together_compile_each_library_once(tmp_path, monkeypatch):
    """A data-parallel job's ranks start together and each loads the
    kernels: the build directory's lock lets one compile, and the others
    find its library."""
    import threading

    from detectron_tpu_torch import _build

    (tmp_path / "k.cu").write_text("source\n")
    compiler = tmp_path / "nvcc"
    compiler.write_text(f'#!/bin/sh\necho run >> {tmp_path / "runs"}\nsleep 0.3\n'
                        'while [ "$1" != "-o" ]; do shift; done\necho library > "$2"\n')
    compiler.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(compiler))
    ranks = [threading.Thread(target=_build.build, args=(["k"],)) for _ in range(3)]
    for t in ranks:
        t.start()
    for t in ranks:
        t.join()
    assert (tmp_path / "runs").read_text().splitlines() == ["run"]
    assert _build.library_path("k").read_text() == "library\n"
