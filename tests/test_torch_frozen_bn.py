"""Frozen BatchNorm, its ReLU and the residual add as one pass
(``ops/frozen_bn.py``, ``csrc/frozen_bn.cu``, ``models/resnet.py``).

* The plain twin, through :class:`FrozenBatchNorm` and its autograd
  Function, equals the eager chain it replaced (the scale and bias worked
  out inline from the four buffers, ``x * s + b``, the residual add, its
  own norm for the downsample, ``F.relu``) bit for bit, output and
  gradients, in float32 and bf16, NCHW and channels-last, in each form.
* The CUDA kernel's source, built with g++ against a host emulation of the
  few CUDA pieces it uses (``tests/cuda_host_emulation.h``: every thread of
  every block run in turn, bf16 rounded to nearest even), equals the plain
  twin bit for bit, sign of zero included, forward and backward, in every
  form, dtype and layout, at shapes that take the 16-byte and the
  one-element instances, stride over the grid, or come misaligned, in the
  other layout or not dense; and through the wrappers and the Function.
* The scale and bias are kept between calls and worked out again after
  ``load_state_dict``, a ``copy_`` into a buffer, or a replaced buffer.
* A ResNet-50 with random weights gives the same ``c2``-``c5`` and
  gradients as the eager chain, with and without ``remat``; the GroupNorm
  path is the eager one; ``bench.calibrate_frozen_bn`` sets every norm's
  statistics, the downsample's too.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch
from torch.nn import functional as F

from detectron_tpu_torch import _build
from detectron_tpu_torch.bench import calibrate_frozen_bn
from detectron_tpu_torch.models.precision import Conv2d
from detectron_tpu_torch.models.resnet import FrozenBatchNorm, GroupNorm, ResNet
from detectron_tpu_torch.ops import frozen_bn as fb

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
HEADER = Path(__file__).resolve().parent / "cuda_host_emulation.h"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def random_norm(c, dtype, gen) -> FrozenBatchNorm:
    bn = FrozenBatchNorm(c, dtype=dtype)
    bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
    bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
    bn.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
    bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return bn


def eager_norm(bn, x):
    """The frozen norm as the eager chain applied it: the scale and bias from
    the four buffers on every call, then two broadcast passes."""
    if isinstance(bn, GroupNorm):
        return bn(x)
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    bias = bn.bias - bn.running_mean * scale
    dt = bn.compute_dtype
    return x * scale.to(dt)[None, :, None, None] + bias.to(dt)[None, :, None, None]


def eager_chain(form, n3, x, r=None, ds=None):
    out = eager_norm(n3, x)
    if form == "identity":
        out = out + r
    elif form == "downsample":
        out = out + eager_norm(ds, r)
    return F.relu(out)


def inputs(form, dtype, layout, shape=(2, 16, 5, 7), seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(shape, generator=gen)).to(dtype).contiguous(memory_format=layout)
    r = None
    if form != "affine":
        r = (2.0 * torch.randn(shape, generator=gen)).to(dtype).contiguous(memory_format=layout)
    n3 = random_norm(shape[1], dtype, gen)
    ds = random_norm(shape[1], dtype, gen) if form == "downsample" else None
    weight = torch.randn(shape, generator=gen)
    return x, r, n3, ds, weight


def call(n3, x, r, ds):
    return n3(x) if r is None else n3(x, r, ds)


@pytest.mark.parametrize("form", fb.FORMS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_pass_equals_the_eager_chain(dtype, layout, form):
    x, r, n3, ds, weight = inputs(form, DTYPES[dtype], LAYOUTS[layout])
    leaves = [t.clone().requires_grad_(True) for t in (x, r) if t is not None]
    twins = [t.clone().requires_grad_(True) for t in (x, r) if t is not None]
    y = call(n3, *leaves, *([None] * (2 - len(leaves))), ds)
    want = eager_chain(form, n3, *twins, ds)
    assert y.dtype == want.dtype and torch.equal(y, want)
    assert y.is_contiguous(memory_format=LAYOUTS[layout])
    got = torch.autograd.grad((y.float() * weight).sum(), leaves)
    expect = torch.autograd.grad((want.float() * weight).sum(), twins)
    for a, b in zip(got, expect):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_graph_where_no_gradient_is_wanted():
    x, r, n3, ds, _ = inputs("downsample", torch.bfloat16, torch.channels_last)
    y = n3(x, r, ds)
    assert y.grad_fn is None
    with torch.no_grad():
        assert n3(x.requires_grad_(True), r, ds).grad_fn is None


# --------------------------------------------------- the kernel, emulated


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/frozen_bn.cu`` built by g++ against the host emulation: the
    includes swapped for the header, each ``<<<...>>>`` launch for a call
    that runs its grid in turn."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ not found: the host emulation of csrc/frozen_bn.cu needs it")
    src = (_build.CSRC / "frozen_bn.cu").read_text()
    src = src.replace("#include <cuda_bf16.h>", f'#include "{HEADER}"')
    src = src.replace("#include <cuda_runtime.h>", "")
    src, launches = re.subn(r"kernel<<<grid, block, 0, a\.stream>>>\(",
                            "emulate_launch(kernel, grid, block, ", src)
    assert launches == 2  # the forward's and the backward's
    out = tmp_path_factory.mktemp("frozen_bn")
    (out / "frozen_bn_host.cpp").write_text(src)
    proc = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                           str(out / "frozen_bn_host.so"), str(out / "frozen_bn_host.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "frozen_bn_host.so"))
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    tail = [ctypes.c_longlong, i32, ctypes.c_longlong, ptr]
    lib.frozen_bn_forward.argtypes = [i32] * 3 + [ptr] * 7 + tail
    lib.frozen_bn_backward.argtypes = [i32] * 3 + [ptr] * 6 + tail
    lib.frozen_bn_forward.restype = lib.frozen_bn_backward.restype = i32
    return lib


@pytest.fixture
def on_host(emulated, monkeypatch):
    """The wrappers' CUDA route with CPU tensors taken for CUDA ones and
    the emulated library in place of the built one."""
    monkeypatch.setattr(fb, "_frozen_bn_lib", lambda: emulated)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    fb.frozen_bn_act_cuda.launches = fb.frozen_bn_act_backward_cuda.launches = 0
    return emulated


def bitwise_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(BITS[a.dtype]),
                            b.contiguous().view(BITS[b.dtype])))


# (N, C, H, W): 16-byte vectors in both layouts; C or H*W not a multiple of
# the vector (one element a vector); a grid that strides over the rows; more
# columns than a block has threads; H*W = 1 (dense in both layouts)
EMULATED_SHAPES = ((2, 16, 5, 8), (2, 24, 3, 5), (4, 8, 40, 50), (1, 4096, 2, 3), (2, 40, 1, 1))


@pytest.mark.parametrize("form", fb.FORMS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_the_host_equals_the_plain_twin(on_host, dtype, layout, form):
    code = fb.FORMS.index(form)
    for i, shape in enumerate(EMULATED_SHAPES):
        x, r, n3, ds, weight = inputs(form, DTYPES[dtype], LAYOUTS[layout], shape, seed=i)
        s, b = n3.scale_bias()
        rs, rb = ds.scale_bias() if ds is not None else (None, None)
        want = fb.frozen_bn_act_plain(x, s, b, r, rs, rb)
        got = fb.frozen_bn_act_cuda(x, s, b, r, rs, rb)
        assert bitwise_equal(got, want), shape
        assert got.is_contiguous(memory_format=LAYOUTS[layout])
        g = weight.to(x.dtype).contiguous(memory_format=LAYOUTS[layout])
        wx, wr = fb.frozen_bn_act_backward_plain(g, want, s, rs, code)
        gx, gr = fb.frozen_bn_act_backward_cuda(g, got, s, rs, code)
        assert bitwise_equal(gx, wx), shape
        assert (gr is None) == (wr is None) and (gr is None or bitwise_equal(gr, wr)), shape
    assert fb.frozen_bn_act_cuda.launches == len(EMULATED_SHAPES)
    assert fb.frozen_bn_act_backward_cuda.launches == len(EMULATED_SHAPES)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_the_host_takes_misaligned_mixed_and_strided_inputs(on_host, dtype):
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(3)
    n3, ds = random_norm(16, dt, gen), random_norm(16, dt, gen)
    (s, b), (rs, rb) = n3.scale_bias(), ds.scale_bias()
    x = torch.randn(1 + 2 * 16 * 4 * 8, generator=gen).to(dt)[1:].view(2, 16, 4, 8)
    r = torch.randn(2, 16, 4, 8, generator=gen).to(dt).contiguous(
        memory_format=torch.channels_last)
    strided = torch.randn(2, 4, 16, 8, generator=gen).to(dt).transpose(1, 2)
    for args in ((x, s, b), (x, s, b, r), (x, s, b, r, rs, rb), (strided, s, b, r),
                 (r, s, b, x, rs, rb)):
        assert bitwise_equal(fb.frozen_bn_act_cuda(*args), fb.frozen_bn_act_plain(*args))


@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_kernel_through_the_function_and_remat(on_host, dtype):
    """ResNet-50 with every frozen norm on the emulated kernel: the eager
    chain's levels and gradients, bit for bit, with remat too."""
    resnet, x, weights = small_resnet(DTYPES[dtype], "channels_last")
    want, want_grads = levels_and_grads(resnet, x, weights, eager=True)
    for remat in (False, True):
        resnet.remat = remat
        got, got_grads = levels_and_grads(resnet, x, weights)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert all(torch.equal(got_grads[k], want_grads[k]) for k in want_grads)
    blocks = 3 + 4 + 6 + 3
    norms = sum(isinstance(m, FrozenBatchNorm) for m in resnet.modules())
    assert norms == 1 + 3 * blocks + 4  # the stem, three a block, four downsamples
    # a forward launches one pass a norm but the downsamples'; the frozen
    # stem and layer1 record no graph, so each backward launches one a norm
    # of layer2-4, whose forwards remat runs twice
    trainable = 3 * (4 + 6 + 3)
    assert fb.frozen_bn_act_cuda.launches == 2 * (1 + 3 * blocks) + trainable
    assert fb.frozen_bn_act_backward_cuda.launches == 2 * trainable


# ------------------------------------------------------- the scale cache


@pytest.mark.parametrize("change", ["load_state_dict", "copy_", "replaced"])
def test_scale_and_bias_follow_every_change_of_a_buffer(change):
    gen = torch.Generator().manual_seed(5)
    bn, other = random_norm(8, torch.bfloat16, gen), random_norm(8, torch.bfloat16, gen)
    x = torch.randn(2, 8, 3, 4, generator=gen).bfloat16()
    first = bn.scale_bias()
    assert all(a is b for a, b in zip(bn.scale_bias(), first))  # kept while nothing changes
    assert torch.equal(bn(x), F.relu(eager_norm(bn, x)))
    if change == "load_state_dict":
        bn.load_state_dict(other.state_dict())
    elif change == "copy_":
        bn.running_var.copy_(other.running_var)
    else:
        bn.running_mean = other.running_mean.clone()
    assert not all(torch.equal(a, b) for a, b in zip(bn.scale_bias(), first))
    assert torch.equal(bn(x), F.relu(eager_norm(bn, x)))


def test_state_dict_keeps_the_four_buffers():
    bn = FrozenBatchNorm(4)
    bn.scale_bias()
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean", "running_var"]


# ---------------------------------------------------------- whole ResNet


def small_resnet(dtype, layout, norm="frozen_bn", seed=0):
    torch.manual_seed(seed)
    resnet = ResNet("resnet50", frozen_stages=1, norm=norm, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    for m in resnet.modules():
        if isinstance(m, FrozenBatchNorm):
            m.load_state_dict(random_norm(m.weight.numel(), dtype, gen).state_dict())
        if isinstance(m, Conv2d):
            m.memory_format = LAYOUTS[layout]
    x = torch.randn(1, 3, 64, 96, generator=gen).contiguous(memory_format=LAYOUTS[layout])
    weights = {f"c{i}": torch.randn(1, 64 << i, 64 >> i, 96 >> i, generator=gen)
               for i in range(2, 6)}
    return resnet, x, weights


def eager_resnet(m, x, norm=eager_norm):
    """The eager chain: each norm (``norm(bn, x)``) as two broadcast passes,
    then the ReLU; ``F.relu(out + residual)`` at a block's end."""
    x = F.max_pool2d(F.relu(norm(getattr(m, m.stem_norm), m.conv1(x))), 3, stride=2, padding=1)
    feats = {}
    for stage in range(4):
        for block in getattr(m, f"layer{stage + 1}"):
            n1, n2, n3 = (getattr(block, n) for n in block.norm_names)
            out = F.relu(norm(n1, block.conv1(x)))
            out = F.relu(norm(n2, block.conv2(out)))
            residual = x
            if block.downsample_conv is not None:
                residual = norm(getattr(block, block.downsample_name), block.downsample_conv(x))
            x = F.relu(norm(n3, block.conv3(out)) + residual)
        if stage + 1 <= m.frozen_stages:
            x = x.detach()
        feats[f"c{stage + 2}"] = x
    return feats


def levels_and_grads(resnet, x, weights, eager=False):
    resnet.zero_grad(set_to_none=True)
    feats = eager_resnet(resnet, x) if eager else resnet(x)
    sum((f.float() * weights[k]).sum() for k, f in feats.items()).backward()
    return ({k: f.detach() for k, f in feats.items()},
            {n: p.grad for n, p in resnet.named_parameters() if p.grad is not None})


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype,layout", [("float32", "nchw"), ("bfloat16", "channels_last")])
def test_resnet_equals_the_eager_chain(dtype, layout, remat):
    resnet, x, weights = small_resnet(DTYPES[dtype], layout)
    want, want_grads = levels_and_grads(resnet, x, weights, eager=True)
    resnet.remat = remat
    got, got_grads = levels_and_grads(resnet, x, weights)
    assert list(got) == ["c2", "c3", "c4", "c5"]
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert set(got_grads) == set(want_grads) and len(got_grads) == 3 * (4 + 6 + 3) + 3
    assert all(torch.equal(got_grads[k], want_grads[k]) for k in want_grads)


@pytest.mark.parametrize("dtype", DTYPES)
def test_group_norm_path_is_the_eager_chain(dtype):
    resnet, x, weights = small_resnet(DTYPES[dtype], "nchw", norm="gn")
    assert not any(isinstance(m, FrozenBatchNorm) for m in resnet.modules())
    want, want_grads = levels_and_grads(resnet, x, weights, eager=True)
    got, got_grads = levels_and_grads(resnet, x, weights)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(got_grads[k], want_grads[k]) for k in want_grads)


def test_calibration_sets_every_norm_the_downsamples_too():
    resnet, x, _ = small_resnet(torch.float32, "nchw")

    class Module(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = resnet

        def features(self, images):
            return self.backbone(images)

    calibrate_frozen_bn(Module(), x)
    # each norm's input, from the eager chain on the calibrated statistics:
    # calibration sets a norm before it is applied, so the inputs are these
    names = {m: n for n, m in resnet.named_modules() if isinstance(m, FrozenBatchNorm)}
    inputs_of = {}

    def record(bn, t):
        inputs_of[names[bn]] = t.float()
        return eager_norm(bn, t)

    with torch.no_grad():
        eager_resnet(resnet, x, record)
    assert set(inputs_of) == set(names.values()) and len(names) == 1 + 3 * 16 + 4
    for name, t in inputs_of.items():
        bn = resnet.get_submodule(name)
        assert torch.equal(bn.running_mean, t.mean(dim=(0, 2, 3))), name
        assert torch.equal(bn.running_var, t.var(dim=(0, 2, 3), unbiased=False)), name


# ------------------------------------------------------------ the wrappers


def test_cpu_path_counts_no_launch():
    fb.frozen_bn_act_cuda.launches = fb.frozen_bn_act_backward_cuda.launches = 0
    resnet, x, weights = small_resnet(torch.bfloat16, "channels_last")
    levels_and_grads(resnet, x, weights)
    assert fb.frozen_bn_act_cuda.launches == 0
    assert fb.frozen_bn_act_backward_cuda.launches == 0


def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 2, 2)
    s = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        fb.frozen_bn_act_cuda(x, s, s)
    with pytest.raises(TypeError, match="float16"):
        fb.frozen_bn_act_cuda(x.half(), s.half(), s.half())
    with pytest.raises(ValueError, match="CUDA"):
        fb.frozen_bn_act_backward_cuda(x, x, s)
