"""A numpy model of kernel K1's wide scan (csrc/nms.cu,
nms_scan_wide_kernel: NMS past 8192 boxes), held against the port's plain
greedy walk and the host oracle ``nms_numpy``; and the check that refuses,
when a detector is built, a config whose NMS the kernel does not take.

The card alone runs the kernel (chip_smoke.py holds it exactly against the
plain version at N = 8193, 10000, 16384 and 20000); here the walk's
algorithm is checked: the removed-bits words kept in one array, each
chunk's keep set as the fixpoint of its diagonal words, and only the kept
rows' live words [rb + 1, W) fetched, in windows whose pieces are widened
to 16-byte alignment, as the kernel's bulk copies fetch them.
"""

import numpy as np
import pytest
import torch

from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.ops import nms as tnms
from detectron_tpu_torch.ops.boxes import bbox_overlaps

STAGE_WORDS = 8192  # kWideStageWords of csrc/nms.cu


def make_problem(seed, n, n_invalid):
    """Clustered boxes sorted by score, the last ``n_invalid`` invalid (as
    nms_padded_batched hands them to the kernel: sorted, padding last)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 1000, size=(n // 8 + 1, 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(16, 200, size=(n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = np.linspace(1.0, 0.0, n, dtype=np.float32)  # distinct, descending
    valid = np.ones(n, bool)
    if n_invalid:
        valid[n - n_invalid:] = False
    return boxes, scores, valid


def mask_words(boxes, thresh):
    """nms_mask_kernel's output for one problem, flat: ``[64 * W * W]``
    uint64, row i's word cb at ``i * W + cb``, bit j of it = box i
    suppresses box 64 * cb + j (j > i, IoU > thresh, the port's
    bbox_overlaps arithmetic); the lower triangle and the padding rows
    hold garbage, as on the card, which the walk must never read."""
    n = len(boxes)
    words = -(-n // 64)
    rng = np.random.RandomState(1)
    flat = np.frombuffer(rng.bytes(8 * 64 * words * words), np.uint64).copy()
    t = torch.tensor(boxes)
    cols = np.arange(words * 64)
    for r0 in range(0, n, 512):
        rows = np.arange(r0, min(r0 + 512, n))
        sup = np.zeros((len(rows), words * 64), bool)
        sup[:, :n] = (bbox_overlaps(t[rows], t) > thresh).numpy()
        sup &= cols[None, :] > rows[:, None]
        packed = np.packbits(sup.reshape(len(rows), words, 64), axis=-1, bitorder="little")
        row_words = packed.reshape(len(rows), words * 8).view(np.uint64)
        for k, i in enumerate(rows):
            first = i // 64  # the upper triangle: words rb..W-1
            flat[i * words + first:(i + 1) * words] = row_words[k, first:]
    return flat, words


def fixpoint(alive, diag):
    """The chunk's keep set: K = alive & ~OR(diagonal words of K's rows)."""
    kept = alive
    while True:
        sup = 0
        for r in range(64):
            if (kept >> r) & 1:
                sup |= int(diag[r])
        nxt = alive & ~sup
        if nxt == kept:
            return kept
        kept = nxt


def wide_scan(flat, words, valid, n, max_keep, stage_words=STAGE_WORDS, log=None):
    """nms_scan_wide_kernel in numpy: returns the keep mask ``[N]``."""
    removed = np.zeros(words, np.uint64)
    keep = np.zeros(n, bool)
    kept = 0
    for rb in range(words):
        if kept >= max_keep:
            break
        i0 = rb * 64
        nrow = min(64, n - i0)
        vword = sum(1 << r for r in range(nrow) if valid[i0 + r])
        diag = [flat[(i0 + r) * words + rb] if r < nrow else 0 for r in range(64)]
        kept_bits = fixpoint(vword & ~int(removed[rb]), diag)
        done = False
        if kept + bin(kept_bits).count("1") >= max_keep:
            while kept + bin(kept_bits).count("1") > max_keep:
                kept_bits &= ~(1 << (kept_bits.bit_length() - 1))
            done = True
        count = bin(kept_bits).count("1")
        kept += count
        order = [r for r in range(64) if (kept_bits >> r) & 1]
        if not done and rb + 1 < words and count:
            slot = (stage_words // count) & ~1
            span = slot - 2
            for wa in range(rb + 1, words, span):
                wb = min(words, wa + span)
                stage = np.zeros(stage_words, np.uint64)
                piece = []
                for k, r in enumerate(order):
                    row = (i0 + r) * words
                    first = (row + wa) & ~1
                    end = (row + wb + 1) & ~1
                    # a 16-byte aligned span that holds the window, within the mask
                    assert first % 2 == 0 and end % 2 == 0 and end - first <= slot
                    assert first >= row + rb and end <= len(flat)
                    assert first <= row + wa and end >= row + wb
                    stage[k * slot:k * slot + end - first] = flat[first:end]
                    piece.append(k * slot + (row + wa - first) - wa)
                assert len(order) * slot <= stage_words
                if log is not None:
                    log.append((rb, wa, wb, count))
                at = np.array(piece)[:, None] + np.arange(wa, wb)[None, :]
                removed[wa:wb] |= np.bitwise_or.reduce(stage[at], axis=0)
        for r in range(nrow):
            keep[i0 + r] = bool((kept_bits >> r) & 1)
        if done:
            break
    return keep


@pytest.mark.parametrize("n,n_invalid,max_keep", [(8193, 0, None), (8193, 700, 300),
                                                  (9000, 1500, None), (9000, 0, 1000)])
def test_wide_scan_model_matches_the_plain_walk_and_nms_numpy(n, n_invalid, max_keep):
    """Past 8192 boxes (W = 129 and 141 words a row), with invalid boxes and
    with max_keep: the model's keep mask equals greedy_keep_plain's (at
    N = 8193) or nms_numpy's on the valid boxes (at N = 9000, where the
    plain walk's N x N IoU would take 300 MB), and a small stage forces
    several windows a chunk with the same result."""
    thresh = 0.5
    boxes, scores, valid = make_problem(n, n, n_invalid)
    flat, words = mask_words(boxes, thresh)
    assert words == -(-n // 64) > 128
    cap = n if max_keep is None else max_keep
    windows = []
    got = wide_scan(flat, words, valid, n, cap, log=windows)
    if n == 8193:
        want = tnms.greedy_keep_plain(torch.tensor(boxes)[None], torch.tensor(valid)[None],
                                      thresh, max_keep=max_keep)[0].numpy()
    else:
        nv = int(valid.sum())
        dets = np.concatenate([boxes[:nv], scores[:nv, None]], 1)
        order = np.array(tnms.nms_numpy(dets, thresh), np.int64)  # descending score
        want = np.zeros(n, bool)
        want[order[:cap]] = True
    np.testing.assert_array_equal(got, want)
    assert got.sum() == min(cap, want.sum()) and not got[valid.sum():].any()
    small = []
    np.testing.assert_array_equal(wide_scan(flat, words, valid, n, cap, 256, small), got)
    assert len(small) > len(windows)  # more, narrower windows
    assert any(b - a == (256 // c & ~1) - 2 for _, a, b, c in small)  # a full window


def test_a_chunk_of_kept_boxes_fills_the_stage_in_windows():
    """64 boxes kept in a chunk (boxes that never overlap): 128 staged words
    a row, windows of 126 words, the whole stage in use."""
    n = 64 * 140
    x = np.arange(n, dtype=np.float32) * 20.0
    boxes = np.stack([x, x, x + 10, x + 10], 1)
    flat, words = mask_words(boxes, 0.5)
    windows = []
    got = wide_scan(flat, words, np.ones(n, bool), n, n, log=windows)
    assert got.all()
    assert windows[:2] == [(0, 1, 127, 64), (0, 127, 140, 64)]


def test_nms_contract_names_the_key_past_the_kernels_limit():
    """Every config in the repo's sizes passes; a config whose NMS exceeds
    NMS_MAX_BOXES (64 x the wide scan's 20000 shared-memory words) is
    refused when the detector is built, naming its key and the limit."""
    assert tnms.NMS_MAX_BOXES == 64 * 20000
    mask = get_config(None, ["model.name=mask_rcnn", "rpn.post_nms_topk_test=3000"])
    assert dict(tnms.nms_problem_sizes(mask))["rpn.post_nms_topk_test"] == 12000
    tnms.check_nms_contract(mask)
    retina = get_config(None, ["model.name=retinanet", "retinanet.pre_nms_topk=2000"])
    assert tnms.nms_problem_sizes(retina) == [("retinanet.pre_nms_topk", 10000)]
    tnms.check_nms_contract(retina)
    for override, key in (("rpn.pre_nms_topk_test=2000000", "rpn.pre_nms_topk_test"),
                          ("rpn.post_nms_topk_test=400000", "rpn.post_nms_topk_test"),
                          ("retinanet.pre_nms_topk=300000", "retinanet.pre_nms_topk"),
                          ("retinanet.merged_pre_nms_topk=1300000",
                           "retinanet.merged_pre_nms_topk")):
        model = "retinanet" if override.startswith("retinanet") else "faster_rcnn"
        cfg = get_config(None, [f"model.name={model}", override])
        with pytest.raises(ValueError, match=key + r": NMS problems of \d+ boxes; kernel K1 "
                                             r"takes at most 1280000"):
            tnms.check_nms_contract(cfg)
