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
# max_out far below the kept count: greedy_keep's walk stops early
CUT_CASES = [(400, 0.5, 7), (129, 0.5, 1), (300, 0.6, 64)]
CASES += CUT_CASES


def make_chain(n, thresh, n_invalid=0):
    """A suppression chain: box i overlaps box i + 1 with IoU above
    ``thresh`` and box i + 2 below it, scores fall with i, so greedy NMS
    keeps every other box and each decision hangs on the one before."""
    # boxes 100 wide shifted by s overlap with IoU (100 - s) / (100 + s),
    # which is thresh at s_t: neighbours (s < s_t) suppress, i and i + 2
    # (2 s > s_t) do not
    step = 0.75 * 100.0 * (1 - thresh) / (1 + thresh)
    x = np.arange(n) * step
    boxes = np.stack([x, np.zeros(n), x + 100.0, np.full(n, 50.0)], 1).astype(np.float32)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = n_invalid == 0
    return boxes, scores, valid


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


@pytest.mark.parametrize("n,thresh,max_out", CUT_CASES)
def test_cut_cases_equal_pallas_interpret(n, thresh, max_out):
    boxes, scores, valid = make_case(n, n, n_invalid=n // 10)
    want_idx, want_ok = jax_nms(boxes, scores, valid, thresh, max_out, "pallas")
    idx, ok = tnms.nms_padded(torch.tensor(boxes), torch.tensor(scores), thresh, max_out,
                              valid=torch.tensor(valid))
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


@pytest.mark.parametrize("algo", ["loop", "tiled", "fixpoint", "pallas"])
@pytest.mark.parametrize("n,thresh,max_out", [(200, 0.5, 13), (257, 0.7, 100), (90, 0.3, 45)])
def test_max_out_cutting_a_chain_equals_jax(algo, n, thresh, max_out):
    boxes, scores, valid = make_chain(n, thresh, n_invalid=n // 9)
    full = tnms.greedy_keep_plain(torch.tensor(boxes)[None], torch.tensor(valid)[None], thresh)
    assert full[0, :valid.sum()].tolist() == [i % 2 == 0 for i in range(valid.sum())]
    want_idx, want_ok = jax_nms(boxes, scores, valid, thresh, max_out, algo)
    idx, ok = tnms.nms_padded(torch.tensor(boxes), torch.tensor(scores), thresh, max_out,
                              valid=torch.tensor(valid))
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


def _problems(seed, g=4, n=300):
    cases = [make_case(seed + i, n, n_invalid=(17 * i) % 40) for i in range(g)]
    boxes, scores, valid = (np.stack(x) for x in zip(*cases))
    order = np.argsort(-np.where(valid, scores, -1e10), axis=1, kind="stable")
    sboxes = np.take_along_axis(boxes, order[..., None], 1)
    return torch.tensor(sboxes), torch.tensor(np.take_along_axis(valid, order, 1))


@pytest.mark.parametrize("where", ["below", "at", "above"])
@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_greedy_keep_plain_max_keep_is_the_full_mask_cut(where, thresh):
    """max_keep=m keeps exactly the first m kept boxes of the full mask."""
    sboxes, svalid = _problems(int(thresh * 10))
    full = tnms.greedy_keep_plain(sboxes, svalid, thresh)
    counts = full.sum(1)
    m = {"below": int(counts.min()) // 2, "at": int(counts.max()),
         "above": int(counts.max()) + 5}[where]
    got = tnms.greedy_keep_plain(sboxes, svalid, thresh, max_keep=m)
    want = full.clone()
    for row in want:
        row[row.nonzero()[m:, 0]] = False
    assert torch.equal(got, want)
    assert (got.sum(1) == counts.clamp(max=m)).all()
    if where != "below":
        assert torch.equal(got, full)
    assert torch.equal(tnms.greedy_keep(sboxes, svalid, thresh, max_keep=m), got)


def test_greedy_keep_plain_max_keep_zero_keeps_nothing():
    sboxes, svalid = _problems(3, g=2, n=70)
    assert not tnms.greedy_keep_plain(sboxes, svalid, 0.5, max_keep=0).any()


@pytest.mark.parametrize("n,max_out", [(300, 100), (300, 300), (120, 400)])
def test_nms_padded_batched_hands_min_max_out_n_to_greedy_keep(monkeypatch, n, max_out):
    calls = []
    greedy_keep = tnms.greedy_keep

    def recorder(*args, **kwargs):
        calls.append(kwargs.get("max_keep"))
        return greedy_keep(*args, **kwargs)

    monkeypatch.setattr(tnms, "greedy_keep", recorder)
    boxes, scores, valid = (torch.tensor(x)[None] for x in make_case(n, n, n_invalid=9))
    idx, ok = tnms.nms_padded_batched(boxes, scores, valid, 0.5, max_out)
    assert calls == [min(max_out, n)]
    monkeypatch.setattr(tnms, "greedy_keep", lambda *a, **k: greedy_keep(*a[:4]))
    idx_full, ok_full = tnms.nms_padded_batched(boxes, scores, valid, 0.5, max_out)
    assert torch.equal(idx, idx_full) and torch.equal(ok, ok_full)


def test_greedy_keep_cuda_rejects_a_negative_max_keep():
    with pytest.raises(ValueError):
        tnms.greedy_keep_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool), 0.5,
                              max_keep=-1)
