"""What the per-layer metrics' readers share. Each returns None where the
run left nothing to read, and the metric is then left out."""

from __future__ import annotations

import statistics

from benchmark.harness import roofline


def mean_ms(run, key: str):
    samples = run.stats.get(key)
    return 1e3 * statistics.fmean(samples) if samples else None


def mfu_pct(run):
    """Model FLOPs done in the window over its seconds and the bf16 peak."""
    per_call, calls = run.stats.get("flops_per_call"), run.stats.get("calls")
    if not per_call or not calls:
        return None
    return 100.0 * per_call * calls / run.stats["elapsed_s"] / roofline.PEAK_BF16_FLOPS


def roofline_pct(run, kernels, bound_key: str):
    """A kernel's bound over its device time a call, from the traced
    slice (its kernels by name) and the bound of one call's inputs."""
    tr, bound = run.stats.get("trace"), run.stats.get(bound_key)
    if tr is None or not bound:
        return None
    per_call = tr.kernel_seconds(kernels) / run.stats["trace_calls"]
    return 100.0 * bound / per_call if per_call > 0 else None


def idle_pct(run):
    tr = run.stats.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
