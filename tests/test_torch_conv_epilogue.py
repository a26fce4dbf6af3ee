"""A convolution's epilogue as one pass at inference (``ops/conv_epilogue.py``,
``csrc/conv_epilogue.cu``, ``models/precision.py::conv_bias_act``).

* The plain twin equals the eager chain it stands for (aten's
  ``output.add_(bias)`` after a convolution run without its bias, the FPN's
  ``lat + F.interpolate(...)``, ``F.relu``) and the rounding it documents
  (each op in float, rounded to the dtype), bit for bit, in every form,
  dtype and layout, at C = 3, 12, 80 and 256.
* The CUDA kernel's source, built with g++ against a host emulation that
  runs each block's threads as real threads (``tests/cuda_thread_emulation.h``),
  equals the twin bit for bit, sign of zero included, in every form, dtype
  and layout, at shapes that take the 16-byte and the one-element
  instances, leave threads of a block without a row, stride over the grid,
  or come misaligned or not dense; it writes over its input, and an input
  without elements launches nothing.
* The FPN (both level sets), ``RPNHead`` and ``MaskHead`` under
  ``torch.no_grad()`` equal the inline chain they replaced, through the
  twin and through the emulated kernel (with its launches counted); where a
  gradient is recorded they run the eager ops as before: the same outputs
  and gradients, and no launch.
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
from detectron_tpu_torch.models.fpn import FPN, pad_same_stride2
from detectron_tpu_torch.models.heads import MaskHead, RPNHead
from detectron_tpu_torch.models.precision import ConvTranspose2d
from detectron_tpu_torch.ops import conv_epilogue as ce

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
FORMS = {"bias": (False, False), "bias_relu": (True, False), "bias_coarse": (False, True),
         "bias_coarse_relu": (True, True)}  # (relu, coarse)
HEADER = Path(__file__).resolve().parent / "cuda_thread_emulation.h"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def bitwise_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(BITS[a.dtype]),
                            b.contiguous().view(BITS[b.dtype])))


def pass_inputs(form, dtype, layout, shape, seed=0):
    """A convolution's output ``x`` (a quarter of it exact zeros and negative
    zeros, so that the sign of zero is held), its bias and, for the coarse
    forms, the merged level above."""
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = 2.0 * torch.randn(shape, generator=gen)
    zeros = torch.rand(shape, generator=gen) < 0.25
    x = torch.where(zeros, torch.where(torch.rand(shape, generator=gen) < 0.5, 0.0, -0.0), x)
    bias = torch.randn(c, generator=gen)
    bias[: c // 4] = 0.0  # x + b exact for those channels: -0.0 + 0.0 and the zeros pass
    coarse = None
    if FORMS[form][1]:
        coarse = (2.0 * torch.randn(n, c, h // 2, w // 2, generator=gen)).to(dtype).contiguous(
            memory_format=layout)
    return x.to(dtype).contiguous(memory_format=layout), bias.to(dtype), coarse


def eager_chain(x, bias, relu, coarse):
    """What the model ran before the pass, as aten runs it on the card: the
    convolution's output, then ``output.add_(bias)``; the FPN's ``lat +
    F.interpolate(td)``; ``F.relu``."""
    y = x.clone()
    y.add_(bias.reshape(1, -1, 1, 1))
    if coarse is not None:
        y = y + F.interpolate(coarse, scale_factor=2, mode="nearest")
    return F.relu(y) if relu else y


def rounding_model(x, bias, relu, coarse):
    """The pass as the kernel computes it: each op in float32, rounded to
    the dtype; the coarse level read at (h // 2, w // 2); ReLU last."""
    def rnd(v):
        return v.to(x.dtype).float()

    z = rnd(x.float() + bias.float()[None, :, None, None])
    if coarse is not None:
        up = coarse.float().repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        z = rnd(z + up)
    if relu:
        z = torch.where(z < 0, torch.zeros_like(z), z)
    return z.to(x.dtype)


@pytest.mark.parametrize("c", [3, 12, 80, 256])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_equals_the_eager_chain(dtype, layout, form, c):
    relu, _ = FORMS[form]
    x, bias, coarse = pass_inputs(form, DTYPES[dtype], LAYOUTS[layout], (2, c, 6, 10), seed=c)
    got = ce.conv_epilogue_plain(x, bias, relu=relu, coarse=coarse)
    assert bitwise_equal(got, eager_chain(x, bias, relu, coarse))
    assert torch.equal(got, eager_chain(x, bias, relu, coarse))
    assert bitwise_equal(got, rounding_model(x, bias, relu, coarse))
    assert got.is_contiguous(memory_format=LAYOUTS[layout])


def test_cpu_dispatch_takes_the_twin_and_counts_nothing():
    ce.conv_epilogue_cuda.launches = 0
    x, bias, coarse = pass_inputs("bias_coarse_relu", torch.bfloat16, torch.channels_last,
                                  (1, 8, 4, 6))
    got = ce.conv_epilogue(x, bias, relu=True, coarse=coarse)
    assert bitwise_equal(got, ce.conv_epilogue_plain(x, bias, relu=True, coarse=coarse))
    assert ce.conv_epilogue_cuda.launches == 0


# --------------------------------------------------- the kernel, emulated


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/conv_epilogue.cu`` built by g++ against the thread emulation:
    the includes swapped for the header, the ``<<<...>>>`` launch for a call
    that runs the grid block by block, each block's threads at once."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ not found: the host emulation of csrc/conv_epilogue.cu needs it")
    src = (_build.CSRC / "conv_epilogue.cu").read_text()
    src = src.replace("#include <cuda_bf16.h>", f'#include "{HEADER}"')
    src = src.replace("#include <cuda_runtime.h>", "")
    src, launches = re.subn(r"kernel<<<grid, block, 0, a\.stream>>>\(",
                            "emulate_launch(kernel, grid, block, ", src)
    assert launches == 1
    out = tmp_path_factory.mktemp("conv_epilogue")
    (out / "conv_epilogue_host.cpp").write_text(src)
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-o",
                           str(out / "conv_epilogue_host.so"),
                           str(out / "conv_epilogue_host.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "conv_epilogue_host.so"))
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.conv_epilogue.argtypes = [i32] + [ptr] * 3 + [ctypes.c_longlong] + [i32] * 3 + [ptr]
    lib.conv_epilogue.restype = i32
    return lib


@pytest.fixture
def on_host(emulated, monkeypatch):
    """The wrapper's CUDA route with CPU tensors taken for CUDA ones and the
    emulated library in place of the built one."""
    monkeypatch.setattr(ce, "_conv_epilogue_lib", lambda: emulated)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    ce.conv_epilogue_cuda.launches = 0
    return emulated


# (N, C, H, W): C a multiple of both vectors, coarse W (5) of neither; C = 3,
# so that a channels-last block of 85 rows of 3 leaves its last thread
# without a row; C = 12 (bf16 one element a vector, float32 16 bytes); the
# mask logits' 80 on a 2x2 coarse level; a grid that strides over the rows
# in both layouts, coarse W 24 (16-byte NCHW coarse vectors); C = 256 on an
# odd coarse level (3 x 1)
EMULATED_SHAPES = ((2, 16, 6, 10), (1, 3, 6, 8), (2, 12, 10, 6), (1, 80, 4, 4),
                   (2, 16, 40, 48), (1, 256, 6, 2))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_the_host_equals_the_twin(on_host, dtype, layout, form):
    relu, _ = FORMS[form]
    for i, shape in enumerate(EMULATED_SHAPES):
        x, bias, coarse = pass_inputs(form, DTYPES[dtype], LAYOUTS[layout], shape, seed=i)
        want = ce.conv_epilogue_plain(x, bias, relu=relu, coarse=coarse)
        ptr = x.data_ptr()
        got = ce.conv_epilogue_cuda(x, bias, relu=relu, coarse=coarse)
        assert got is x and got.data_ptr() == ptr  # written over the convolution's output
        assert bitwise_equal(got, want), shape
        assert got.is_contiguous(memory_format=LAYOUTS[layout])
    assert ce.conv_epilogue_cuda.launches == len(EMULATED_SHAPES)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_the_host_takes_misaligned_mixed_and_strided_inputs(on_host, dtype):
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(3)
    bias = torch.randn(16, generator=gen).to(dt)

    def misaligned(shape, layout=torch.contiguous_format):
        flat = torch.randn(1 + torch.Size(shape).numel(), generator=gen).to(dt)[1:]
        if layout == torch.channels_last:
            n, c, h, w = shape
            return flat.view(n, h, w, c).permute(0, 3, 1, 2)
        return flat.view(shape)

    fine, coarse = (2, 16, 8, 16), (2, 16, 4, 8)
    cases = (
        (misaligned(fine), None),  # x one element past 16 bytes: one element a vector
        (misaligned(fine, torch.channels_last), misaligned(coarse, torch.channels_last)),
        (torch.randn(fine, generator=gen).to(dt), misaligned(coarse)),
        # a coarse level in the other layout (copied once), and a strided x (a dense copy)
        (torch.randn(fine, generator=gen).to(dt),
         torch.randn(coarse, generator=gen).to(dt).contiguous(memory_format=torch.channels_last)),
        (torch.randn(2, 8, 16, 16, generator=gen).to(dt).transpose(1, 2)[:, :, :8], None),
    )
    for relu in (False, True):
        for x, c in cases:
            want = ce.conv_epilogue_plain(x, bias, relu=relu, coarse=c)
            assert bitwise_equal(ce.conv_epilogue_cuda(x.clone(), bias, relu=relu, coarse=c),
                                 want)


def test_wrapper_refuses_what_the_kernel_does_not_take(on_host):
    x = torch.zeros(1, 8, 4, 6)
    with pytest.raises(TypeError, match="float16"):
        ce.conv_epilogue_cuda(x.half(), torch.zeros(8).half())
    with pytest.raises(ValueError, match="bias"):
        ce.conv_epilogue_cuda(x, torch.zeros(4))
    with pytest.raises(ValueError, match="coarse"):
        ce.conv_epilogue_cuda(x, torch.zeros(8), coarse=torch.zeros(1, 8, 3, 3))
    with pytest.raises(ValueError, match="coarse"):
        ce.conv_epilogue_cuda(x, torch.zeros(8), coarse=torch.zeros(1, 8, 2, 3).bfloat16())


@pytest.mark.parametrize("form", FORMS)
def test_kernel_on_the_host_counts_no_launch_for_an_empty_input(on_host, form):
    """An input without elements launches nothing and counts nothing; the
    next input that has them counts one launch."""
    relu, _ = FORMS[form]
    for shape in ((0, 16, 6, 10), (2, 16, 6, 10)):
        x, bias, coarse = pass_inputs(form, torch.bfloat16, torch.channels_last, shape)
        want = ce.conv_epilogue_plain(x, bias, relu=relu, coarse=coarse)
        assert bitwise_equal(ce.conv_epilogue_cuda(x, bias, relu=relu, coarse=coarse), want)
        assert ce.conv_epilogue_cuda.launches == shape[0] // 2


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ce.conv_epilogue_cuda(torch.zeros(1, 8, 2, 2), torch.zeros(8))


# ------------------------------------------------- the FPN and the heads


def aten_conv(conv, x):
    """A convolution as aten runs it on the card: without its bias, then
    ``output.add_(bias)``."""
    dt = conv.compute_dtype
    weight = conv.weight.to(dt, memory_format=conv.memory_format)
    if isinstance(conv, ConvTranspose2d):
        y = F.conv_transpose2d(x.to(dt), weight, None, conv.stride, conv.padding,
                               conv.output_padding, conv.groups, conv.dilation)
    else:
        y = F.conv2d(x.to(dt), weight, None, conv.stride, conv.padding, conv.dilation,
                     conv.groups)
    return y.add_(conv.bias.to(dt).reshape(1, -1, 1, 1))


def module_conv(conv, x):
    return conv(x)


def inline_fpn(fpn, feats, conv):
    """The FPN's forward before the pass: every lateral, then the top-down
    adds, then the smoothing convs."""
    first = fpn.first
    lateral = [conv(getattr(fpn, f"lateral{i}"), feats[f"c{i}"]) for i in range(first, 6)]
    tds = [lateral[-1]]
    for lat in reversed(lateral[:-1]):
        tds.append(lat + F.interpolate(tds[-1], scale_factor=2, mode="nearest"))
    tds = tds[::-1]
    ps = [conv(getattr(fpn, f"smooth{first + i}"), t) for i, t in enumerate(tds)]
    if fpn.levels == "p2p6":
        return ps + [ps[-1][:, :, ::2, ::2]]
    p6 = fpn.p6(pad_same_stride2(feats["c5"]))
    return ps + [p6, fpn.p7(pad_same_stride2(F.relu(p6)))]


def inline_rpn(head, x, conv):
    t = F.relu(conv(head.conv, x))
    b = x.shape[0]
    return (conv(head.objectness, t).permute(0, 2, 3, 1).reshape(b, -1),
            conv(head.deltas, t).permute(0, 2, 3, 1).reshape(b, -1, 4))


def inline_mask(head, x, conv):
    b, r, h, w, c = x.shape
    x = x.reshape(b * r, h, w, c).permute(0, 3, 1, 2).contiguous(memory_format=head.memory_format)
    for i in range(4):
        x = F.relu(conv(getattr(head, f"conv{i}"), x))
    x = conv(head.mask_logits, F.relu(conv(head.deconv, x)))
    return x.permute(0, 2, 3, 1).reshape(b, r, 2 * h, 2 * w, -1)


CH = 32  # model.fpn_channels in the CPU tests
IN_CHANNELS = (16, 24, 32, 40)  # c2..c5


def set_layout(module, layout):
    for m in module.modules():
        if hasattr(m, "memory_format"):
            m.memory_format = layout
    return module


def randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return module


def fpn_case(levels, dtype, layout, seed=0):
    torch.manual_seed(seed)
    fpn = set_layout(randomize(FPN(IN_CHANNELS, CH, levels=levels, dtype=dtype), seed), layout)
    gen = torch.Generator().manual_seed(seed + 1)
    canvas = (64, 96)
    feats = {f"c{i}": torch.randn(2, cin, canvas[0] >> i, canvas[1] >> i, generator=gen).to(
        dtype).contiguous(memory_format=layout) for i, cin in zip(range(2, 6), IN_CHANNELS)}
    return fpn, feats


def rpn_case(dtype, layout, seed=0):
    head = set_layout(randomize(RPNHead(CH, 3, dtype=dtype), seed), layout)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(2, CH, 16, 24, generator=gen).to(dtype).contiguous(memory_format=layout)
    return head, x


def mask_case(dtype, layout, seed=0):
    head = set_layout(randomize(MaskHead(CH, 81, CH, dtype=dtype), seed), layout)
    gen = torch.Generator().manual_seed(seed + 1)
    return head, torch.randn(2, 5, 14, 14, CH, generator=gen).to(dtype)


MODULES = {
    "fpn_p2p6": (lambda dt, lay: fpn_case("p2p6", dt, lay), inline_fpn, 8),
    "fpn_p3p7": (lambda dt, lay: fpn_case("p3p7", dt, lay), inline_fpn, 6),
    "rpn_head": (rpn_case, inline_rpn, 3),
    "mask_head": (mask_case, inline_mask, 6),
}  # (inputs, the inline chain, passes a call)


def outputs_of(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("route", ["twin", "kernel"])
@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("dtype,layout", [("float32", "nchw"), ("bfloat16", "channels_last"),
                                          ("bfloat16", "nchw")])
def test_inference_equals_the_inline_chain(request, module, dtype, layout, route):
    """Under ``torch.no_grad()``: the module's outputs equal the chain it
    replaced as the card runs it, bit for bit, through the twin (CPU
    tensors) and through the emulated kernel, one launch a pass."""
    make, inline, passes = MODULES[module]
    mod, x = make(DTYPES[dtype], LAYOUTS[layout])
    ce.conv_epilogue_cuda.launches = 0
    with torch.no_grad():
        want = outputs_of(inline(mod, x, aten_conv))
        if route == "kernel":
            request.getfixturevalue("on_host")
        got = outputs_of(mod(x))
    assert len(got) == len(want)
    assert all(bitwise_equal(g, w) for g, w in zip(got, want))
    assert all(g.stride() == w.stride() for g, w in zip(got, want))
    assert ce.conv_epilogue_cuda.launches == (passes if route == "kernel" else 0)


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("dtype,layout", [("float32", "nchw"), ("bfloat16", "channels_last")])
def test_training_records_the_graph_it_always_had(on_host, module, dtype, layout):
    """Where a gradient is recorded the eager ops run: the outputs and every
    gradient equal the inline chain's with the modules' own biased
    convolutions, and no pass is launched, even on a CUDA tensor."""
    make, inline, _ = MODULES[module]
    mod, x = make(DTYPES[dtype], LAYOUTS[layout])
    leaves = list(x.values()) if isinstance(x, dict) else [x]

    def grads(fn):
        mod.zero_grad(set_to_none=True)
        ins = [t.detach().clone().requires_grad_(True) for t in leaves]
        arg = dict(zip(x, ins)) if isinstance(x, dict) else ins[0]
        outs = outputs_of(fn(arg))
        gen = torch.Generator().manual_seed(7)
        loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum() for o in outs)
        loss.backward()
        return (outs, [t.grad for t in ins],
                {n: p.grad for n, p in mod.named_parameters() if p.grad is not None})

    got = grads(mod)
    want = grads(lambda arg: inline(mod, arg, module_conv))
    assert all(bitwise_equal(g.detach(), w.detach()) for g, w in zip(got[0], want[0]))
    assert all((g is None and w is None) or bitwise_equal(g, w)  # p3p7 reads no c2
               for g, w in zip(got[1], want[1]))
    assert set(got[2]) == set(want[2]) == {n for n, _ in mod.named_parameters()}
    assert all(bitwise_equal(got[2][k], want[2][k]) for k in want[2])
    assert ce.conv_epilogue_cuda.launches == 0
