"""The schedule of kernel K2's bf16 kernel (csrc/roi_align.cu,
roi_align_forward_bf16_kernel: persistent, warp-specialised), modelled
here, where no card runs it: its units, strided over the blocks, cover
every (RoI, channel slice) exactly once; its tables, stages and fp32 ring fit two blocks an SM
at the shapes it takes; and its barrier protocol (set-up, copy and
consumer roles, double-buffered tables, a ring of stages, mbarrier phase
parities) hands every role the right table and stage under any
interleaving, without deadlock. The arithmetic is the fp32 kernel's,
held by tests/test_torch_roi_align.py's numpy model at this kernel's stage
and ring sizes; chip_smoke.py holds the kernel against its plain version
on the card.
"""

import numpy as np
import pytest

# csrc/roi_align.cu: the bf16 kernel's constants
STAGES = 4
STAGE_BYTES = 16 * 1024
RING_BYTES = 32 * 1024
SMEM_LIMIT = 95 * 1024  # dynamic bytes a block
CONSUMER_WARPS, COPY_WARPS, SETUP_WARPS = 8, 4, 2
THREADS = 32 * (CONSUMER_WARPS + COPY_WARPS + SETUP_WARPS)
BLOCKS_PER_SM = 2
UNITS_PER_BLOCK = 4
SM_SHARED = 228 * 1024  # an H100 SM's shared memory, of which each block reserves 1 KB
MAX_TAPS, MAX_SAMPLES = 128, 64


def static_bytes():
    """sizeof(Bf16Shared): two FwdTaps, one FwdSetup and 12 mbarriers."""
    fwd_taps = 4 * (2 + 2 * MAX_TAPS + 2 * MAX_SAMPLES) + 8 * 2 * MAX_TAPS + 4 * MAX_SAMPLES
    axis_taps = 4 * (1 + MAX_TAPS + (MAX_TAPS + 1) + 2 * MAX_TAPS)
    fold_scratch = 4 * (4 * MAX_SAMPLES + MAX_TAPS)
    roi_table = 4 * 4 * 2 * MAX_SAMPLES + 2 * axis_taps + 2 * fold_scratch
    fwd_setup = roi_table + 4 * 2 * 2 * MAX_SAMPLES
    return 2 * fwd_taps + fwd_setup + 8 * (2 * STAGES + 4)


def bf16_plan(channels, pool, ratio):
    """bf16_slice, bf16_ring_rows, bf16_stage_cells and bf16_smem_bytes:
    (slice, ring rows, stage cells, dynamic bytes), or None if refused."""
    for slice_ in (64, 32, 8):
        rows = 1
        while rows < 4 * ratio:
            rows *= 2
        while 2 * rows * pool * slice_ * 4 <= RING_BYTES:
            rows *= 2
        cells = max(2 * pool * ratio, STAGE_BYTES // (slice_ * 2))
        smem = rows * pool * slice_ * 4 + STAGES * cells * slice_ * 2
        if channels % slice_ == 0 and smem <= SMEM_LIMIT:
            return slice_, rows, cells, smem
    return None


def test_static_tables_are_what_the_compiler_reported():
    """ptxas reported 18048 bytes of static shared memory for every
    instance on the card (NVIDIA H100 80GB HBM3)."""
    assert static_bytes() == 18048


@pytest.mark.parametrize("channels", [256, 32, 24])
@pytest.mark.parametrize("ratio", [1, 2, 3])
@pytest.mark.parametrize("pool", [7, 14])
def test_tables_stages_and_ring_fit_two_blocks_an_sm(pool, ratio, channels):
    """At P in {7, 14}, S in {1, 2, 3} and C in {256, 32, 24} a slice width
    is found whose ring and four stages, with the static tables, let two
    blocks share an SM; every fold's chunk of rows fits a stage, and the
    ring holds a chunk plus the 2*S - 1 rows an unfinished bin still
    reads; a stage holds at least one row of the widest fold."""
    plan = bf16_plan(channels, pool, ratio)
    assert plan is not None
    slice_, rows, cells, smem = plan
    assert channels % slice_ == 0 and slice_ * 2 % 16 == 0
    assert BLOCKS_PER_SM * (smem + static_bytes() + 1024) <= SM_SHARED
    assert rows & (rows - 1) == 0 and rows >= 4 * ratio and cells >= 2 * pool * ratio
    for nx in range(1, 2 * pool * ratio + 1):
        chunk = min(cells // nx, rows - 2 * ratio + 1)
        assert chunk >= 1 and chunk * nx <= cells and chunk + 2 * ratio - 1 <= rows
    if channels == 256 and ratio == 2:  # the main path: what the card reported
        assert plan == (64, 16 if pool == 7 else 8, 128, 94208)


def unit_slices(num_rois, slices, blocks):
    """bf16_unit_slices: a unit's slices, all of a RoI's, halved (while they
    divide) until there are UNITS_PER_BLOCK units a block."""
    per = slices
    while per % 2 == 0 and num_rois * (slices // per) < UNITS_PER_BLOCK * blocks:
        per //= 2
    return per


def block_items(num_rois, slices, sms):
    """Each block's walk, as (RoI, slice) items in its order: units (a RoI
    and ``per`` of its slices) strided over min(units, 2 x SMs) blocks."""
    per = unit_slices(num_rois, slices, BLOCKS_PER_SM * sms)
    return block_items_of(num_rois, slices, sms, per), per


def block_items_of(num_rois, slices, sms, per):
    blocks = BLOCKS_PER_SM * sms
    groups = slices // per
    units = num_rois * groups
    grid = min(units, blocks)
    return [[(u // groups, (u % groups) * per + j) for u in range(b, units, grid)
             for j in range(per)] for b in range(grid)]


@pytest.mark.parametrize("num_rois,slices,sms", [(1024, 4, 132), (600, 4, 132), (256, 4, 132),
                                                 (200, 4, 132), (7, 32, 132), (14400, 4, 132),
                                                 (3, 1, 132)])
def test_items_cover_every_roi_slice_once(num_rois, slices, sms):
    """The walks cover every (RoI, slice) exactly once; each unit's slices
    are one RoI's, consecutive, set up once; the blocks' unit counts differ
    by at most one; a unit keeps all of a RoI's slices where there are
    RoIs enough for four units a block (14400 at the bench's batch), two at
    the main path's 600-1024 RoIs at P=7, one at its 200-256 at P=14."""
    walks, per = block_items(num_rois, slices, sms)
    flat = [item for walk in walks for item in walk]
    assert sorted(flat) == [(n, j) for n in range(num_rois) for j in range(slices)]
    for walk in walks:
        units = [walk[i:i + per] for i in range(0, len(walk), per)]
        assert all(len({n for n, _ in unit}) == 1 for unit in units)
        assert all([j for _, j in unit] == list(range(unit[0][1], unit[0][1] + per))
                   for unit in units)
    sizes = [len(walk) // per for walk in walks]
    assert max(sizes) - min(sizes) <= 1
    assert per == {(1024, 4): 2, (600, 4): 2, (256, 4): 1, (200, 4): 1, (7, 32): 1,
                   (14400, 4): 4, (3, 1): 1}[(num_rois, slices)]


class Barrier:
    """An mbarrier: ``count`` arrivals complete a phase; try_wait.parity(p)
    succeeds once the phase of parity p is the last completed (a fresh
    barrier's phase -1 has parity 1)."""

    def __init__(self, count):
        self.count, self.pending, self.completed = count, count, 0

    def arrive(self):
        self.pending -= 1
        assert self.pending >= 0
        if self.pending == 0:
            self.completed += 1
            self.pending = self.count

    def ready(self, parity):
        return (self.completed & 1) != parity


def run_protocol(chunks, slices, seed, copy_releases=True, consumers=3, copiers=2):
    """One block's walk over units (a RoI and its ``slices`` slices) with
    ``chunks[n]`` chunks a slice (0: no sample inside the level), its roles
    (the set-up, ``copiers`` copy warps, ``consumers`` consumer warps)
    interleaved at random: the set-up fills table k & 1 for the k-th unit
    once every consumer and copy warp has released it; each copy warp fills
    its part of stage seq % STAGES (the bytes landing later, at random)
    once every consumer warp has released the stage; each consumer warp
    reads the table and every part of the stage, and releases both by its
    own arrival. Asserts every read sees what its role expects; raises on
    deadlock. ``copy_releases``: the copy warps release each table too (the
    kernel); without it, the consumers alone do."""
    rng = np.random.RandomState(seed)
    units = len(chunks)
    full = [Barrier(copiers) for _ in range(STAGES)]  # each copy warp's bytes landing
    empty = [Barrier(consumers) for _ in range(STAGES)]
    tab_full = [Barrier(1) for _ in range(2)]
    tab_empty = [Barrier(consumers + (copiers if copy_releases else 0)) for _ in range(2)]
    table, stage, landing = [None, None], [[None] * copiers for _ in range(STAGES)], []

    def setup():
        for k in range(units):
            yield lambda k=k: tab_empty[k & 1].ready(((k >> 1) & 1) ^ 1)
            table[k & 1] = k
            tab_full[k & 1].arrive()

    def copy(w):
        seq = 0
        for k in range(units):
            yield lambda k=k: tab_full[k & 1].ready((k >> 1) & 1)
            assert table[k & 1] == k, "a copy warp read another unit's table"
            for j in range(slices):
                for c in range(chunks[k]):
                    s = seq % STAGES
                    yield lambda s=s, seq=seq: empty[s].ready(((seq // STAGES) & 1) ^ 1)
                    landing.append((s, w, (k, j, c)))
                    seq += 1
            if copy_releases:
                tab_empty[k & 1].arrive()

    def consume():
        seq = 0
        for k in range(units):
            yield lambda k=k: tab_full[k & 1].ready((k >> 1) & 1)
            assert table[k & 1] == k, "a consumer warp read another unit's table"
            for j in range(slices):
                for c in range(chunks[k]):
                    s = seq % STAGES
                    yield lambda s=s, seq=seq: full[s].ready((seq // STAGES) & 1)
                    assert stage[s] == [(k, j, c)] * copiers, "a consumer read another chunk"
                    empty[s].arrive()
                    seq += 1
            tab_empty[k & 1].arrive()

    roles = [setup()] + [copy(w) for w in range(copiers)] + [consume() for _ in range(consumers)]
    waits = [lambda: True] * len(roles)
    while roles or landing:
        runnable = [r for r in range(len(roles)) if waits[r]()]
        if landing and (not runnable or rng.rand() < 0.3):
            s, w, data = landing.pop(rng.randint(len(landing)))
            stage[s][w] = data
            full[s].arrive()
            continue
        if not runnable:
            raise AssertionError("deadlock")
        r = runnable[rng.randint(len(runnable))]
        try:
            waits[r] = next(roles[r])
        except StopIteration:
            del roles[r], waits[r]


@pytest.mark.parametrize("seed", range(12))
def test_barrier_protocol_hands_each_role_its_table_and_stage(seed):
    """Units of 0-5 chunks a slice (a fifth with no sample inside the
    level), 4 slices, roles interleaved at random: every read sees its own
    unit's table and every part of its own chunk, and the walk ends."""
    rng = np.random.RandomState(100 + seed)
    chunks = np.where(rng.rand(12) < 0.2, 0, rng.randint(1, 6, 12))
    run_protocol(list(chunks), 4, seed)


def test_tables_released_by_the_consumers_alone_would_race():
    """Without the copy warps' release, consumers that pass RoIs with no
    chunks free a table a copy warp has not read yet: some interleaving
    then hands it the next-but-one unit's table or deadlocks. The kernel's
    tab_empty therefore waits for both roles."""
    failures = 0
    for seed in range(40):
        try:
            run_protocol([3, 0, 0, 0, 2, 0, 0, 1], 1, seed, copy_releases=False, consumers=1,
                         copiers=1)
        except AssertionError:
            failures += 1
    assert failures > 0
