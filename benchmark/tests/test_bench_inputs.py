"""The traffic generators: a seed repeats its draws, and every seed gets
the same sizes and object counts in its own order."""

import torch

from benchmark.harness import inputs

SETTINGS = {"canvas": [128, 192], "short_side": 96, "max_size": 160, "num_classes": 81}


def batches(seed):
    return inputs.coco_like_batches(seed, 2, 3, SETTINGS, torch.device("cpu"))


def test_batches_repeat_for_a_seed():
    a, b = batches(2 ** 33 + 5), batches(2 ** 33 + 5)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_seeds_share_sizes_and_counts_not_pixels():
    a, b = batches(1), batches(2)
    hw = lambda bs: sorted(map(tuple, torch.cat([x["image_hw"] for x in bs]).tolist()))
    count = lambda bs: sorted((torch.cat([x["gt_classes"] for x in bs]) > 0).sum(1).tolist())
    assert hw(a) == hw(b)
    assert count(a) == count(b)
    assert not torch.equal(a[0]["image"], b[0]["image"])


def test_object_counts_are_coco_like():
    counts = inputs.object_counts(64, inputs.rng_for(0, 0))
    assert 5.5 <= counts.mean() <= 8.5
    assert counts.min() >= 1 and 25 <= counts.max() <= inputs.COUNT_MAX

