"""The port's NMS (plain path, as it runs on CPU tensors) against the JAX
package: the loop, tiled and fixpoint ``nms_padded``, ``nms_pallas`` in
interpret mode, and ``nms_numpy``. Keep sets must be exactly equal: idx
and valid slot for slot. The CUDA kernel is held against the same plain
path on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops import nms as jnms
from detectron_tpu.ops.nms_pallas import nms_pallas
from detectron_tpu_torch.ops import nms as tnms


def make_case(seed, n, n_invalid=0, ties=True):
    """Clustered boxes (suppression chains), exact score ties, and padded
    invalid slots (score -1e10, as generate_proposals pads)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 400, size=(max(n // 6, 1), 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(10, 120, size=(n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores[1::5] = scores[0]
    valid = np.ones(n, bool)
    if n_invalid:
        valid[n - n_invalid:] = False
        scores[n - n_invalid:] = -1e10
    return boxes, scores, valid


def jax_nms(boxes, scores, valid, thresh, max_out, algo):
    if algo == "pallas":
        idx, ok = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out,
                             valid=jnp.asarray(valid), interpret=True)
    else:
        idx, ok = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out,
                                  valid=jnp.asarray(valid), algo=algo)
    return np.asarray(idx), np.asarray(ok)


CASES = [(50, 0.5, 30), (50, 0.7, 80), (129, 0.5, 129), (129, 0.7, 60), (1000, 0.7, 300),
         (1000, 0.5, 1200)]


@pytest.mark.parametrize("algo", ["loop", "tiled", "fixpoint"])
@pytest.mark.parametrize("n,thresh,max_out", CASES)
def test_nms_padded_equals_jax(algo, n, thresh, max_out):
    boxes, scores, valid = make_case(n, n, n_invalid=n // 10)
    want_idx, want_ok = jax_nms(boxes, scores, valid, thresh, max_out, algo)
    idx, ok = tnms.nms_padded(torch.tensor(boxes), torch.tensor(scores), thresh, max_out,
                              valid=torch.tensor(valid))
    assert idx.dtype == torch.int32 and idx.shape == (max_out,)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


@pytest.mark.parametrize("n,thresh", [(50, 0.5), (129, 0.7), (300, 0.6)])
def test_nms_padded_equals_pallas_interpret(n, thresh):
    boxes, scores, valid = make_case(n + 1, n, n_invalid=7)
    want_idx, want_ok = jax_nms(boxes, scores, valid, thresh, n, "pallas")
    idx, ok = tnms.nms_padded(torch.tensor(boxes), torch.tensor(scores), thresh, n,
                              valid=torch.tensor(valid))
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


@pytest.mark.parametrize("n,thresh", [(50, 0.5), (129, 0.7), (1000, 0.7)])
def test_nms_padded_equals_numpy_oracle(n, thresh):
    boxes, scores, _ = make_case(n + 2, n, ties=False)
    want = jnms.nms_numpy(np.concatenate([boxes, scores[:, None]], 1), thresh)
    assert want == tnms.nms_numpy(np.concatenate([boxes, scores[:, None]], 1), thresh)
    idx, ok = tnms.nms_padded(torch.tensor(boxes), torch.tensor(scores), thresh, n)
    assert idx[ok].tolist() == want


def test_batched_equals_per_problem_jax():
    """One batched call over G problems (what the RPN sends) equals G
    separate JAX calls."""
    g, n, thresh, max_out = 6, 200, 0.7, 64
    cases = [make_case(100 + i, n, n_invalid=13 * i) for i in range(g)]
    boxes, scores, valid = (np.stack(x) for x in zip(*cases))
    idx, ok = tnms.nms_padded_batched(torch.tensor(boxes), torch.tensor(scores),
                                      torch.tensor(valid), thresh, max_out)
    assert idx.shape == ok.shape == (g, max_out)
    for i in range(g):
        want_idx, want_ok = jax_nms(boxes[i], scores[i], valid[i], thresh, max_out, "tiled")
        np.testing.assert_array_equal(ok[i].numpy(), want_ok)
        np.testing.assert_array_equal(idx[i].numpy(), want_idx)


@pytest.mark.parametrize("n,thresh,max_out", [(120, 0.5, 100), (400, 0.5, 100), (129, 0.3, 200)])
def test_class_aware_equals_jax(n, thresh, max_out):
    boxes, scores, valid = make_case(7 * n, n, n_invalid=n // 8)
    classes = np.random.RandomState(n).randint(1, 5, n).astype(np.int32)
    want_idx, want_ok = jnms.class_aware_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), thresh, max_out,
        valid=jnp.asarray(valid))
    idx, ok = tnms.class_aware_nms(torch.tensor(boxes), torch.tensor(scores),
                                   torch.tensor(classes), thresh, max_out,
                                   valid=torch.tensor(valid))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # batched form: the shift span is per problem
    idx2, ok2 = tnms.class_aware_nms(
        torch.tensor(np.stack([boxes, boxes * 2])), torch.tensor(np.stack([scores] * 2)),
        torch.tensor(np.stack([classes] * 2)), thresh, max_out,
        valid=torch.tensor(np.stack([valid] * 2)))
    np.testing.assert_array_equal(idx2[0].numpy(), idx.numpy())
    np.testing.assert_array_equal(ok2[0].numpy(), ok.numpy())


def test_all_invalid_and_offset():
    boxes, scores, valid = make_case(5, 40)
    idx, ok = tnms.nms_padded(torch.tensor(boxes), torch.tensor(scores), 0.5, 10,
                              valid=torch.zeros(40, dtype=torch.bool))
    assert not ok.any() and (idx == 0).all()
    want_idx, want_ok = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 40,
                                        offset=1.0)
    idx, ok = tnms.nms_padded(torch.tensor(boxes), torch.tensor(scores), 0.5, 40, offset=1.0)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
