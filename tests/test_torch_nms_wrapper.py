"""The port's NMS dispatch, ``ops/nms_wrapper.py::nms``, against the JAX
package's ``detectron_tpu/ops/nms_wrapper.py::nms`` on the same seeded
inputs: ``impl="jnp"`` against JAX's ``impl="jnp"``, and ``impl="pallas",
interpret=True`` (K1's plain walk) against JAX's Pallas kernel in interpret
mode. Results must be exactly equal, idx and valid slot for slot. Kernel K1
itself (``impl="pallas"`` on CUDA tensors) is held against ``impl="jnp"``
on the card by chip_smoke.py (phase 29)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops import nms_wrapper as jwrap
from detectron_tpu_torch.ops import nms as tnms
from detectron_tpu_torch.ops import nms_wrapper as twrap
from test_torch_nms import make_case

# (N, threshold, max_out, invalid slots, offset): max_out below, at and
# above N, an all-invalid problem, the legacy +1 widths
CASES = [(50, 0.5, 30, 0, 0.0), (50, 0.7, 80, 5, 0.0), (129, 0.5, 129, 9, 0.0),
         (129, 0.6, 7, 0, 1.0), (300, 0.7, 1000, 40, 1.0), (64, 0.5, 16, 64, 0.0)]


def run_both(case, impl, interpret=False):
    n, thresh, max_out, n_invalid, offset = case
    boxes, scores, valid = make_case(n, n, n_invalid)
    want = jwrap.nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out,
                     valid=jnp.asarray(valid), offset=offset, impl=impl, interpret=interpret)
    got = twrap.nms(torch.tensor(boxes), torch.tensor(scores), thresh, max_out,
                    valid=torch.tensor(valid), offset=offset, impl=impl, interpret=interpret)
    return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("impl,interpret", [("jnp", False), ("pallas", True)])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_nms_matches_jax(case, impl, interpret):
    (want_idx, want_ok), (idx, ok) = run_both(case, impl, interpret)
    assert idx.dtype == torch.int32 and ok.dtype == torch.bool
    assert idx.shape == ok.shape == (case[2],)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    if case[3] == case[0]:  # all invalid: nothing kept, every slot index 0
        assert not ok.any() and not idx.any()


def test_nms_valid_defaults_to_all():
    boxes, scores, _ = make_case(3, 80)
    want = jwrap.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 40)
    got = twrap.nms(torch.tensor(boxes), torch.tensor(scores), 0.5, 40)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unknown_impl_raises():
    boxes, scores, _ = make_case(1, 20)
    with pytest.raises(ValueError, match="unknown nms impl 'cuda'"):
        twrap.nms(torch.tensor(boxes), torch.tensor(scores), 0.5, 10, impl="cuda")


def test_pallas_on_cpu_tensors_raises_and_does_not_fall_back(monkeypatch):
    """``impl="pallas"`` launches K1 or raises: on CPU tensors it names the
    device and ``interpret=True``, and no walk runs at all."""
    walks = []
    monkeypatch.setattr(tnms, "greedy_keep_plain", lambda *a, **k: walks.append(a))
    boxes, scores, _ = make_case(2, 20)
    with pytest.raises(ValueError, match=r"CUDA tensors, not on cpu.*interpret=True"):
        twrap.nms(torch.tensor(boxes), torch.tensor(scores), 0.5, 10, impl="pallas")
    assert walks == []


def test_reexports_are_the_nms_modules():
    assert twrap.nms_padded is tnms.nms_padded and twrap.nms_numpy is tnms.nms_numpy


@pytest.mark.parametrize("tiled,algo", [(False, "auto"), (True, "tiled"), (True, "loop"),
                                        (True, "fixpoint")])
def test_nms_padded_schedules_leave_the_result_unchanged(tiled, algo):
    """``tiled`` and ``algo`` pick a TPU schedule in the JAX package: the
    port's result is the default's for each, and JAX's for the same
    arguments."""
    boxes, scores, valid = make_case(4, 300, 30)
    args = (torch.tensor(boxes), torch.tensor(scores), 0.6, 100, torch.tensor(valid))
    base = tnms.nms_padded(*args)
    got = tnms.nms_padded(*args, tiled=tiled, algo=algo)
    want = jwrap.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), 0.6, 100,
                            valid=jnp.asarray(valid), tiled=tiled, algo=algo)
    for b, g, w in zip(base, got, want):
        assert torch.equal(b, g)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
