"""The placement scan's split of an eval's node axis over a thread-block
cluster, on the CPU (no card needed).

``kernels.launch_plan`` decides how many CTAs (the cluster size CS) share
one eval's nodes, which contiguous slice each owns and where each region
of a CTA lives; the kernel (``csrc/place_scan.cu``) only follows it. The
plan is held at the main path's shapes. ``sliced_ring_select`` is a plain
model of the kernel's ring scan and selection over that split: per-CTA
partials published and read back in rank order, per-thread runs inside a
CTA, the ring offset counted per CTA and summed, the winner reduced from
per-CTA bests. It must give ``step.ring_select``'s chosen index, score,
rank and pulls, exactly, at every cluster size.
"""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.tpu import kernels, step
from nomad_tpu_torch.tpu.intscore import PACK_COUNT_MAX

BUDGET = kernels.SMEM_PER_CTA - kernels.STATIC_SMEM_RESERVE

# the main path's shapes: (B, N, D, G, S, V, DP, V2, C, int arm, reserved,
# affinity) and the cluster size and slice the plan must give
SHAPES = {
    # a C1M Harness eval (template 0: one targeted spread and an affinity)
    "c1m_harness_eval": (dict(B=1, N=5120, D=4, G=1, S=1, V=2, DP=0, V2=1, int_arm=True,
                              has_reserved=True, has_aff=True), 16, 320),
    # the server's 8-eval batch in the float arm
    "server_batch": (dict(B=8, N=5120, D=4, G=1, S=1, V=2, DP=0, V2=1, int_arm=False,
                          has_reserved=True, has_aff=True), 16, 320),
    # BASELINE config 4's fleet with the candidate axis (C = 16) and a
    # device dim pair
    "config4_preempt": (dict(B=1, N=5120, D=6, G=1, S=0, V=1, DP=0, V2=1, C=16, int_arm=True,
                             has_reserved=True), 16, 320),
    # a test size
    "test_size": (dict(B=1, N=64, D=4, G=3, S=1, V=4, DP=1, V2=3, int_arm=True), 1, 64),
    # the packed-lane limit's far side
    "n_pad_33024": (dict(B=1, N=33024, D=4, G=2, S=1, V=4, DP=0, V2=1, int_arm=True,
                         has_reserved=True), 16, 2064),
}


def _check_plan(plan, dims, batch_rule=True):
    B, N = dims["B"], dims["N"]
    # the slices tile [0, N) in rank order
    assert len(plan.slices) == plan.cs
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == N
    for (lo, hi), (lo2, _) in zip(plan.slices, plan.slices[1:]):
        assert hi == lo2
    assert all(0 <= hi - lo <= plan.per for lo, hi in plan.slices)
    if batch_rule:
        assert B * plan.cs <= kernels.SMS or plan.cs == 1
    assert plan.smem_bytes + kernels.STATIC_SMEM_RESERVE <= 232_448
    # every region in shared memory: aligned, inside, not overlapping
    spans = sorted((off, off + plan.region_bytes[r]) for r, off in plan.shared.items())
    assert all(off % 16 == 0 and end <= plan.smem_bytes for off, end in spans)
    for (_, end), (off, _) in zip(spans, spans[1:]):
        assert end <= off
    # the per-CTA regions always are; any other either is or is marked global
    assert set(kernels.PER_CTA) <= set(plan.shared)
    assert set(plan.shared) | set(plan.in_global) == set(kernels.REGIONS)
    assert set(plan.arena) == set(plan.in_global) & set(kernels.REPLICAS)
    soff = plan.soff()
    for r, o in zip(kernels.REGIONS, soff):
        if r in plan.shared:
            assert o == plan.shared[r]
        elif r in plan.arena:
            assert o == -1 - plan.arena[r] and plan.arena[r] + plan.region_bytes[r] <= plan.arena_bytes
        else:
            assert o == -1


@pytest.mark.parametrize("shape", list(SHAPES))
def test_launch_plan_at_main_path_shapes(shape):
    dims, cs, per = SHAPES[shape]
    plan = kernels.launch_plan(**dims)
    assert (plan.cs, plan.per) == (cs, per)
    _check_plan(plan, dims)
    # at the main path's shapes every region fits in shared memory
    assert plan.in_global == () and plan.arena_bytes == 0


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_launch_plan_at_forced_cluster_sizes(shape, cs):
    dims, _, _ = SHAPES[shape]
    if shape == "n_pad_33024" and cs == 1:
        # 33,024 scores and flags do not fit one CTA
        with pytest.raises(ValueError, match="take a larger CS"):
            kernels.launch_plan(**dims, cs=cs)
        return
    plan = kernels.launch_plan(**dims, cs=cs)
    assert plan.cs == cs and plan.per == -(-dims["N"] // cs)
    _check_plan(plan, dims)


def test_launch_plan_refuses_other_cluster_sizes():
    dims = SHAPES["test_size"][0]
    for cs in (0, 3, 12, 32):
        with pytest.raises(ValueError, match="power of two"):
            kernels.launch_plan(**dims, cs=cs)
    with pytest.raises(ValueError, match="power of two"):
        kernels.launch_plan(**dims, cs=16, max_cs=8)


def test_launch_plan_marks_what_does_not_fit_global():
    """A spread over a per-node attribute (V = N + 1) on a large fleet at
    a forced small CS: the spread-count replica goes to the global arena,
    the per-node slices past the room stay in their tensors."""
    dims = dict(B=1, N=33024, D=4, G=4, S=1, V=33025, DP=1, V2=5, int_arm=True,
                has_reserved=True, has_aff=True)
    plan = kernels.launch_plan(**dims, cs=2)
    _check_plan(plan, dims)
    assert "spread_counts" in plan.arena and plan.arena_bytes >= 4 * 33025 * 4
    # a slice too large stays in its tensor; a smaller one after it fits
    assert "used" in plan.in_global and "spread_vids" in plan.in_global
    assert "job_counts" in plan.shared


def test_launch_plan_picks_smaller_clusters_for_larger_batches():
    dims = dict(SHAPES["server_batch"][0])
    for B, cs in ((1, 16), (8, 16), (9, 8), (16, 8), (17, 4), (33, 4), (34, 2), (66, 2),
                  (67, 1), (132, 1), (300, 1)):
        dims["B"] = B
        plan = kernels.launch_plan(**dims)
        assert plan.cs == cs, B
        _check_plan(plan, dims)


def test_launch_plan_raises_the_cluster_until_the_scores_fit():
    """Past one CTA's room the plan takes the smallest CS that holds the
    slice's scores and flags, whatever the batch (so B x CS may pass the
    SMs: the CTAs then run in waves)."""
    dims = dict(B=200, N=100_000, D=4, G=1, S=0, V=1, DP=0, V2=1, int_arm=True)
    plan = kernels.launch_plan(**dims)
    assert plan.cs == 8
    _check_plan(plan, dims, batch_rule=False)
    with pytest.raises(ValueError, match="take a larger CS"):
        kernels.launch_plan(**dims, cs=4)


def test_scan_plan_of_cpu_tensors():
    from nomad_tpu_torch.tpu import convert
    from nomad_tpu_torch.tpu.engine import example_scan_variant

    n_pad, st, ca, xs = example_scan_variant("preempt", n_nodes=700, n_tgs=3, n_placements=8,
                                             seed=1)
    batched = (tuple(t.unsqueeze(0) for t in part)
               for part in convert.scan_inputs_to_torch(st, ca, xs, "cpu"))
    plan = kernels.scan_plan(*batched)
    assert plan.cs == 4 and plan.per == n_pad // 4 and plan.region_bytes["rows"] == plan.per * 4


# -- a plain model of the kernel's sliced ring scan ----------------------------

INT32_MAX = 2**31 - 1


def _best(a, b):
    """BestOp: max score, then min rank, then min index."""
    if a[0] != b[0]:
        return a if a[0] > b[0] else b
    if a[1] != b[1]:
        return a if a[1] < b[1] else b
    return a if a[2] <= b[2] else b


def sliced_ring_select(final, feasible, n_real, offset, limit, cs, threads, neg_inf):
    """The kernel's step 3-4 over ``cs`` CTAs of ``threads`` threads:
    (chosen, score, rank, pulls)."""
    n = final.size
    per = -(-n // cs)
    run = -(-per // threads)
    idx = np.arange(n)
    feas_v = feasible & (idx < n_real)
    low = feas_v & (final <= 0)
    before = idx < offset
    slices = [(min(r * per, n), min(r * per + per, n)) for r in range(cs)]

    # pass 1 per CTA: each thread's counts over its run, an exclusive scan
    # over the threads, the CTA's partial (published)
    thread_excl, partials = [], []
    for lo, hi in slices:
        runs = [(min(lo + t * run, hi), min(lo + t * run + run, hi)) for t in range(threads)]
        per_thread = np.array([[low[a:b].sum(), feas_v[a:b].sum(), (low & before)[a:b].sum(),
                                (feas_v & before)[a:b].sum()] for a, b in runs], dtype=np.int64)
        thread_excl.append((runs, np.cumsum(per_thread, axis=0) - per_thread))
        partials.append(per_thread.sum(axis=0))
    # every CTA reads the partials in rank order: totals and its prefix
    tot = np.sum(partials, axis=0)
    low_t, feas_t, low_b, feas_b = (int(v) for v in tot)
    ret_total = feas_t - min(low_t, 3)
    backlog_n = max(limit - ret_total, 0)

    # pass 2 per CTA: natural-order inclusive counts from the lower-rank
    # CTAs, the lower threads and the thread's own run; the CTA's best
    cta_best = []
    for r, (runs, excl) in enumerate(thread_excl):
        pfx = np.sum(partials[:r], axis=0) if r else np.zeros(4, dtype=np.int64)
        best, pulls = (neg_inf, INT32_MAX, INT32_MAX), 0
        for (a, b), ex in zip(runs, excl):
            nat_low, nat_feas = int(pfx[0] + ex[0]), int(pfx[1] + ex[1])
            for i in range(a, b):
                nat_low += int(low[i])
                nat_feas += int(feas_v[i])
                low_cum = nat_low - low_b if i >= offset else nat_low + low_t - low_b
                feas_cum = nat_feas - feas_b if i >= offset else nat_feas + feas_t - feas_b
                skipped = bool(low[i]) and low_cum <= 3
                skip_cum = min(low_cum, 3)
                ret = bool(feas_v[i]) and not skipped
                ret_excl = feas_cum - skip_cum - int(ret)
                pulled = i < n_real and ret_excl < limit
                src = ret and pulled
                skip_excl = skip_cum - int(skipped)
                if src or (skipped and skip_excl < backlog_n):
                    rank = ret_excl if src else ret_total + skip_excl
                    best = _best(best, (final[i], rank, i))
                pulls += pulled
        cta_best.append((best, pulls))
    # the winner from the CTAs' bests, in rank order
    win, pulls = (neg_inf, INT32_MAX, INT32_MAX), 0
    for best, p in cta_best:
        win, pulls = _best(win, best), pulls + p
    chosen = win[2] if win[2] != INT32_MAX else -1
    return chosen, win[0], win[1], pulls


def _ring_case(n, seed, arm):
    rng = np.random.default_rng(seed)
    if arm == "int":
        # few distinct scores (ties), some <= 0 (the skip window)
        final = rng.choice(np.array([-3, 0, 5, 7, 9, 12], dtype=np.int64), n)
        neg_inf = step.NEG_INF
    else:
        final = rng.choice(np.array([-0.5, 0.0, 0.25, 0.5, 0.75], dtype=np.float32), n)
        neg_inf = float("-inf")
    feasible = rng.random(n) < rng.choice([0.05, 0.5, 0.95])
    n_real = int(rng.integers(max(1, n - 40), n + 1))
    offset = int(rng.integers(0, n_real))
    limit = int(rng.choice([1, 2, 3, 8, max(1, n.bit_length()), n]))
    return final, feasible, n_real, offset, limit, neg_inf


@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n,threads", [(8, 512), (64, 4), (997, 16), (5120, 512), (33024, 512)])
@pytest.mark.parametrize("arm", ["int", "float"])
def test_sliced_ring_scan_equals_plain_ring_select(cs, n, threads, arm):
    assert (n >= PACK_COUNT_MAX) == (n == 33024)  # both cumsum branches of step.py
    for seed in range(3):
        final, feasible, n_real, offset, limit, neg_inf = _ring_case(n, seed * 100 + cs, arm)
        want = step.ring_select(torch.from_numpy(final), torch.from_numpy(feasible), n_real,
                                offset, limit, neg_inf)
        got = sliced_ring_select(final, feasible, n_real, offset, limit, cs, threads, neg_inf)
        assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3], (seed, got, want)
        if want[0] >= 0:
            assert got[1] == want[1]


# -- the scan's plan past the clusters the card holds at once -----------------


def test_plan_runs_clusters_in_waves_past_the_resident_count(monkeypatch):
    """N = 33,024 at B = 80 with the card holding 66 clusters of 2 (and
    fewer of the larger sizes): the plan stops at CS 2, the smallest
    cluster whose slices fit, and the 80 clusters run in two waves;
    before, it went down to CS 1 and raised."""
    resident = {1: 132, 2: 66, 4: 33, 8: 16, 16: 7}
    monkeypatch.setattr(kernels, "max_active_clusters",
                        lambda cs, smem, int_arm, device=None: resident[cs])
    m = dict(B=80, N=33024, D=4, G=2, S=1, V=4, DP=0, V2=1, C=0, has_reserved=1, has_aff=0)
    plan = kernels._plan(m, True, None, torch.device("cuda"))
    assert plan.cs == 2 and plan.per == 16512
    _check_plan(plan, m, batch_rule=False)
    assert kernels.scan_waves(plan, 80, True) == 2
    # where every size the slices fit is resident B times, the plan drops
    # as before
    m["B"] = 8
    assert kernels._plan(m, True, None, torch.device("cuda")).cs == 8
    # a forced size the card cannot hold at all still raises
    resident[4] = 0
    with pytest.raises(RuntimeError, match="cannot co-schedule"):
        kernels._plan(m, True, 4, torch.device("cuda"))


# -- the chunk kernel's plan and a plain model of its cluster select ----------

CHUNK_BUDGET = kernels.SMEM_PER_CTA - kernels.STATIC_SMEM_RESERVE


@pytest.mark.parametrize("N,K,cs,list_in_smem", [
    (5120, 128, 16, True),      # the chunked server's evals
    (5120, 1024, 16, True),     # the C1M chunk run's bulk
    (33024, 1024, 16, True),    # the packed-lane limit's far side
    (8192, 5000, 16, False),    # past the shared-memory list
    (32768, 32768, 16, False),  # K = n_pad
    (64, 16, 1, True),          # a test size
])
def test_chunk_plan_at_main_path_shapes(N, K, cs, list_in_smem):
    plan = kernels.chunk_plan(N, 4, 2, 1, 4, K, has_aff=True)
    assert plan.cs == cs and plan.per == -(-N // cs) and plan.list_in_smem == list_in_smem
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == N
    assert all(b == c for (_, b), (c, _) in zip(plan.slices, plan.slices[1:]))
    assert plan.smem_bytes <= CHUNK_BUDGET
    assert set(kernels.CHUNK_PER_CTA) <= set(plan.shared)
    spans = sorted((off, off + plan.region_bytes[r]) for r, off in plan.shared.items())
    assert all(off % 16 == 0 and end <= plan.smem_bytes for off, end in spans)
    assert all(end <= off for (_, end), (off, _) in zip(spans, spans[1:]))
    # at the main path's shapes every input is staged; the list only up to
    # K = 4,096
    assert plan.in_global == (() if list_in_smem else ("list",))
    assert plan.soff() == [plan.shared.get(r, -1) for r in kernels.CHUNK_REGIONS]


@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_chunk_plan_at_forced_cluster_sizes(cs):
    plan = kernels.chunk_plan(33024, 4, 2, 1, 4, 1024, has_aff=True, cs=cs)
    assert plan.cs == cs and plan.per == -(-33024 // cs)
    assert plan.smem_bytes <= CHUNK_BUDGET and plan.list_in_smem
    # at CS 1 and 2 the keys take much of the room: the largest
    # per-node inputs stay in their tensors
    assert ("used" in plan.in_global) == (cs <= 2)
    with pytest.raises(ValueError, match="power of two"):
        kernels.chunk_plan(64, 4, 2, 1, 4, 16, cs=3)
    with pytest.raises(ValueError, match="take a larger CS"):
        kernels.chunk_plan(60_000, 4, 2, 1, 4, 60_000, cs=1)


def test_chunk_plan_drops_a_cluster_the_card_cannot_hold(monkeypatch):
    """On the card the chunk plan drops to the next cluster size down
    while ``cudaOccupancyMaxActiveClusters`` reads 0, as the scan's plan
    does; a forced size the card cannot hold, or a drop whose slice does
    not fit a CTA, raises."""
    resident = {1: 132, 2: 66, 4: 33, 8: 16, 16: 0}
    monkeypatch.setattr(kernels, "chunk_max_active_clusters",
                        lambda cs, smem, device=None: resident[cs])
    cuda = torch.device("cuda")
    m = dict(N=5120, D=4, G=2, S=1, V=4, K=128, has_aff=1)
    assert kernels.chunk_plan(5120, 4, 2, 1, 4, 128, has_aff=True).cs == 16
    plan = kernels._chunk_launch_plan(m, None, cuda)
    assert plan == kernels.chunk_plan(5120, 4, 2, 1, 4, 128, has_aff=True, cs=8)
    assert kernels._chunk_launch_plan(m, 4, cuda).cs == 4
    with pytest.raises(RuntimeError, match="cannot co-schedule a cluster of 16"):
        kernels._chunk_launch_plan(m, 16, cuda)
    # on the CPU nothing is asked of the card
    assert kernels._chunk_launch_plan(m, None, torch.device("cpu")).cs == 16
    # K = n_pad at 32,768 nodes needs CS >= 2: below it no slice fits
    resident.update({16: 0, 8: 0, 4: 0})
    m.update(N=32768, K=32768)
    assert kernels._chunk_launch_plan(m, None, cuda).cs == 2
    resident[2] = 0
    with pytest.raises(RuntimeError, match="no smaller cluster holds the slice"):
        kernels._chunk_launch_plan(m, None, cuda)


NAN_KEY_MIN = 0xFF800001  # the keys of +NaN
NEG_INF_KEY = 0x007FFFFF
POS_INF_KEY = 0xFF800000


def _thread_runs(lo, hi, threads):
    per_run = -(-(hi - lo) // threads) if hi > lo else 0
    return [(min(lo + t * per_run, hi), min(lo + t * per_run + per_run, hi))
            for t in range(threads)]


def cluster_select(keys, K, cs, threads, want_eff, cap=None):
    """The chunk kernel's steps 1-3 over ``cs`` CTAs of ``threads``
    threads on one row of uint32 keys: per-warp histograms of each CTA's
    runs merged, up to four 8-bit passes from the top, each CTA's count
    above the bin and at it. A pass after which the keys at or above its
    bin fit the list (``cap`` entries, ``kernels.chunk_list_cap``) ends
    them: all of them are gathered at each CTA's offset, ranked by
    counting, and those ranked below K taken. Else, after the last pass,
    the winners above the threshold are gathered and ranked, and the
    ties placed by the lower CTAs' counts and a scan over the threads'
    runs. ``placed`` from the first pass's +NaN and valid counts.
    Returns (top_idx [K], placed, passes)."""
    cap = kernels.chunk_list_cap(K) if cap is None else cap
    N = keys.size
    per = -(-N // cs)
    slices = [(min(r * per, N), min(r * per + per, N)) for r in range(cs)]
    runs = [_thread_runs(lo, hi, threads) for lo, hi in slices]
    n_nan = int((keys >= NAN_KEY_MIN).sum())
    n_valid = int(((keys > NEG_INF_KEY) & (keys <= POS_INF_KEY)).sum())
    prefix, rest, exact = 0, K, False
    above, eq = [0] * cs, [0] * cs
    for p in range(4):
        shift = 24 - 8 * p
        hi_mask = 0 if p == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        hists = []
        for r in range(cs):
            warp_hists = np.zeros((-(-threads // 32), 256), np.int64)
            for t, (a, b) in enumerate(runs[r]):
                k = keys[a:b]
                k = k[(k & hi_mask) == prefix]
                np.add.at(warp_hists[t // 32], (k >> shift) & 255, 1)
            hists.append(warp_hists.sum(axis=0))
        total = np.sum(hists, axis=0)
        from_top = total[::-1]
        incl = np.cumsum(from_top)
        j = int(np.nonzero((incl - from_top < rest) & (rest <= incl))[0][0])
        b = 255 - j
        prefix |= b << shift
        rest -= int(incl[j] - from_top[j])
        exact = K - rest + int(total[b]) <= cap  # the keys at or above the bin fit
        for r in range(cs):
            above[r] += int(hists[r][b + 1:].sum()) + (int(hists[r][b]) if exact else 0)
            eq[r] = int(hists[r][b])
        if exact:
            break
    passes = p + 1
    thr, need_eq = prefix, (0 if exact else rest)
    sel_lo = prefix if exact else prefix + 1
    A = sum(above)
    assert A == K - need_eq or (exact and K <= A <= cap)
    # the list: each CTA's winners at its offset (in any order inside)
    lst = np.zeros(A, np.uint64)
    for r, (lo, hi) in enumerate(slices):
        idx = np.arange(lo, hi)
        won = idx[keys[lo:hi].astype(np.int64) >= sel_lo]
        assert won.size == above[r]
        comp = ((~keys[won].astype(np.uint64)) & 0xFFFFFFFF) << np.uint64(32) | won.astype(np.uint64)
        off = sum(above[:r])
        lst[off:off + won.size] = comp[::-1]  # the order inside a CTA is free
    top = np.full(K, -1, np.int64)
    for e in range(A):
        rank = int((lst < lst[e]).sum())
        if rank < K:
            top[rank] = int(lst[e] & np.uint64(0xFFFFFFFF))
    # the ties: the lower CTAs' counts, then each thread's run in order
    for r in range(cs):
        e0 = sum(eq[:r]) if not exact else 0
        counts = [int((keys[a:b] == thr).sum()) if not exact else 0 for a, b in runs[r]]
        for t, (a, b) in enumerate(runs[r]):
            e = e0 + sum(counts[:t])
            for i in range(a, b):
                if e >= need_eq:
                    break
                if not exact and keys[i] == thr:
                    top[A + e] = i
                    e += 1
    placed = max(0, min(n_nan + n_valid, want_eff) - min(n_nan, K))
    return top, placed, passes


def _keys(x):
    from nomad_tpu_torch.tpu import chunk

    return chunk.score_key(torch.from_numpy(x)).numpy().astype(np.uint32)


def _select_cases(n, seed):
    rng = np.random.default_rng(seed)
    pool = np.array([0.25, 0.5, 0.5, 0.75, 0.9, -0.0, 0.0, 1.0], np.float32)
    rows = {
        # few distinct scores: ties everywhere, across slice boundaries
        "ties": rng.choice(pool, n),
        "distinct": rng.random(n).astype(np.float32),
        "all_neg_inf": np.full(n, -np.inf, np.float32),
    }
    # feasible nodes sparse, the padding past n_real at -inf (K = n_real)
    sparse = np.where(rng.random(n) < 0.3, rng.choice(pool, n), -np.inf).astype(np.float32)
    sparse[n - n // 5:] = -np.inf
    rows["sparse_padded"] = sparse
    # one equal block that straddles every slice boundary
    block = np.full(n, 0.25, np.float32)
    block[: n // 3] = rng.random(n // 3).astype(np.float32) + 0.5
    rows["straddle"] = block
    return rows


@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n,threads", [(64, 4), (700, 32), (5120, 512)])
def test_cluster_select_equals_top_k_ordered_and_lax_top_k(cs, n, threads):
    """The model gives ``lax.top_k``'s order at every cluster size, with
    ties across slice boundaries, rows all at -inf and K = n_real."""
    import jax

    from nomad_tpu_torch.tpu import chunk

    for name, x in _select_cases(n, cs * 7 + n).items():
        n_real = int((x > -np.inf).sum())
        for K in sorted({1, 3, max(1, n // 7), max(1, n_real), n}):
            want = chunk.top_k_ordered(torch.from_numpy(x), K)[1].numpy()
            ref = np.asarray(jax.lax.top_k(x, K)[1])
            assert np.array_equal(want, ref), (name, K)
            # the list's room: K (ties past the last pass), the kernel's
            # own, all keys (the first pass ends it)
            for want_eff, cap in ((0, K), (K // 2, None), (K, max(K, n))):
                got, placed, passes = cluster_select(_keys(x), K, cs, threads, want_eff, cap)
                assert np.array_equal(got, want), (name, K, cs, cap)
                vals = x[want]
                assert placed == int(((np.arange(K) < want_eff) & (vals > -np.inf)).sum())
                assert passes == 1 or (cap or kernels.chunk_list_cap(K)) < n


def test_cluster_select_places_no_nan_key():
    """+NaN keys sort above +inf and are never valid; -NaN below -inf:
    ``placed`` counts the valid slots below want_eff all the same."""
    x = np.array([0.5, np.nan, 0.25, -np.inf, 1.0, np.nan, 0.5, -0.0], np.float32)
    x_bits = x.view(np.uint32).copy()
    x_bits[5] = 0xFFC00000  # a NaN with the sign bit set
    x = x_bits.view(np.float32)
    from nomad_tpu_torch.tpu import chunk

    for cs in (1, 2, 4):
        for K in range(1, x.size + 1):
            want = chunk.top_k_ordered(torch.from_numpy(x), K)[1].numpy()
            for want_eff in range(K + 1):
                got, placed, _ = cluster_select(_keys(x), K, cs, 2, want_eff,
                                                cap=[K, K + 1, 2 * K][want_eff % 3])
                assert np.array_equal(got, want)
                vals = x[want]
                assert placed == int(((np.arange(K) < want_eff) & (vals > -np.inf)).sum())
