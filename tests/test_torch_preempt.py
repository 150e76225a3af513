"""Device-side preemption in the port, held against the JAX package.

``nomad_tpu_torch/tpu/preempt.py``'s PyTorch functions (the plain
versions of K8 ``isqrt``/``coord_q``, K6 the greedy sweep and K7 the
second pass) against ``nomad_tpu/tpu/preempt.py``'s jnp functions and
the pure-Python oracle ``select_eviction_set_py``; then the plain scan
with its ``has_pre`` branch (``step.py``, reached through
``kernels.place_scan`` on CPU tensors) against the JAX scan
``_build_place_scan`` on the ``preempt`` and ``preempt_forced``
variants. Inputs are made from a seed with numpy and fed to both sides.
No tolerance: everything here is an exact integer program. One dtype
differs by design: the JAX scan's evict column is int64 (``jnp.sum`` of
int32 ranks under x64), the port's int32 (the kernel writes int32);
their values are compared.
"""
import math
import random

import numpy as np
import pytest
import torch

from nomad_tpu.tpu import preempt as jpreempt
from nomad_tpu.tpu.engine import _build_place_scan

from nomad_tpu_torch.tpu import convert, kernels, preempt, step
from nomad_tpu_torch.tpu.engine import PREEMPT_VARIANTS, example_scan_variant

I64 = torch.int64


@pytest.fixture(scope="module")
def jax_scan():
    # builds the scan first: it turns on x64 before any array converts
    return _build_place_scan()


@pytest.fixture(autouse=True)
def _x64():
    import jax

    jax.config.update("jax_enable_x64", True)


def _jnp(a, dtype=None):
    import jax.numpy as jnp

    return jnp.asarray(a, dtype)


# -- K8 ---------------------------------------------------------------------------


def test_isqrt_exact_against_jnp_and_math():
    rng = np.random.default_rng(11)
    xs = np.concatenate([
        rng.integers(0, 1 << 62, 2000, dtype=np.int64),
        np.array([0, 1, 2, 3, 4, 15, 16, 17, (1 << 62) - 1, (1 << 31) ** 2 - 1,
                  ((1 << 31) - 1) ** 2, ((1 << 31) - 1) ** 2 - 1, 3 * (1 << 60)], np.int64),
    ])
    got = preempt.isqrt_t(torch.from_numpy(xs))
    assert got.dtype == I64
    want = np.array([math.isqrt(int(x)) for x in xs], np.int64)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jpreempt.isqrt_jnp(_jnp(xs))))


def test_coord_q_against_jnp_and_py():
    rng = np.random.default_rng(12)
    needed = rng.integers(-(1 << 28), 1 << 28, 3000, dtype=np.int64)
    res = rng.integers(0, 1 << 28, 3000, dtype=np.int64)
    # negative numerators (res > needed > 0), zero and negative needed
    needed[:5] = [1, 0, -5, 100, 1 << 28]
    res[:5] = [1 << 28, 7, 3, 101, 0]
    got = preempt.coord_q_t(torch.from_numpy(needed), torch.from_numpy(res))
    assert got.dtype == I64
    want = np.array([preempt.coord_q_py(int(n), int(r)) for n, r in zip(needed, res)], np.int64)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          np.asarray(jpreempt.coord_q_jnp(_jnp(needed), _jnp(res))))
    assert (got.numpy() < 0).any()


# -- K6 + K7 against the oracle and jnp --------------------------------------------


def _torch_eviction_set(ask3, remaining3, res3, prio, pen, elig):
    """The two functions composed as the scan composes them, per row."""
    ask = torch.tensor(ask3, dtype=I64)
    sel_ord, met = preempt.greedy_select_t(
        ask, torch.from_numpy(res3), torch.from_numpy(prio),
        torch.from_numpy(pen), torch.from_numpy(elig), torch.from_numpy(remaining3))
    assert sel_ord.dtype == torch.int32 and met.dtype == torch.bool
    out = []
    for ni in range(res3.shape[0]):
        if not bool(met[ni]):
            out.append(None)
            continue
        keep, rank = preempt.second_pass_t(ask, torch.from_numpy(res3[ni]), sel_ord[ni],
                                           torch.from_numpy(remaining3[ni]))
        ks = sorted((i for i in range(res3.shape[1]) if bool(keep[i])), key=lambda i: int(rank[i]))
        out.append(ks)
    return out, sel_ord.numpy(), met.numpy()


def _jnp_greedy(ask3, remaining3, res3, prio, pen, elig):
    sel_ord, met = jpreempt.greedy_select_jnp(
        _jnp(ask3, "int64"), _jnp(res3, "int64"), _jnp(prio, "int32"),
        _jnp(pen, "int64"), _jnp(elig, bool), _jnp(remaining3, "int64"))
    return np.asarray(sel_ord), np.asarray(met)


def _fuzz_tables(rng):
    n = rng.randint(1, 8)
    c = rng.randint(1, preempt.C_MAX)
    ask3 = [rng.randint(1, 1 << 20) for _ in range(3)]
    res3 = np.array([[[rng.randint(0, 1 << 18) for _ in range(3)] for _ in range(c)]
                     for _ in range(n)], np.int64)
    prio = np.array([[rng.choice([10, 20, 20, 30, 40]) for _ in range(c)] for _ in range(n)],
                    np.int32)
    pen = np.array([[preempt.penalty_q_py(rng.choice([0, 0, 1, 2]), rng.choice([0, 1, 2]))
                     for _ in range(c)] for _ in range(n)], np.int64)
    elig = np.array([[rng.random() < 0.8 for _ in range(c)] for _ in range(n)], bool)
    # remaining can be negative (the node is oversubscribed after
    # subtracting every candidate): the common preemption shape
    remaining3 = np.array([[rng.randint(-(1 << 19), 1 << 19) for _ in range(3)]
                           for _ in range(n)], np.int64)
    return ask3, remaining3, res3, prio, pen, elig


@pytest.mark.parametrize("trial", range(30))
def test_eviction_set_fuzz_matches_oracle_and_jnp(trial):
    """The 30 trials of tests/test_preempt_kernels.py:90 (one random
    stream, seed 99): same victims, same final order, same unmet rows as
    the oracle, and the greedy's sel_ord/met and the second pass's
    keep/rank equal the jnp functions'."""
    rng = random.Random(99)
    for _ in range(trial + 1):
        tables = _fuzz_tables(rng)
    ask3, remaining3, res3, prio, pen, elig = tables
    got, sel_ord, met = _torch_eviction_set(*tables)
    j_sel, j_met = _jnp_greedy(*tables)
    assert np.array_equal(sel_ord, j_sel) and np.array_equal(met, j_met)
    for ni in range(res3.shape[0]):
        want = preempt.select_eviction_set_py(ask3, remaining3[ni], res3[ni], prio[ni],
                                              pen[ni], elig[ni])
        assert got[ni] == want, (ni, got[ni], want)
        keep, rank = preempt.second_pass_t(torch.tensor(ask3, dtype=I64),
                                           torch.from_numpy(res3[ni]),
                                           torch.from_numpy(sel_ord[ni]),
                                           torch.from_numpy(remaining3[ni]))
        j_keep, j_rank = jpreempt.second_pass_jnp(_jnp(ask3, "int64"), _jnp(res3[ni], "int64"),
                                                  _jnp(sel_ord[ni], "int32"),
                                                  _jnp(remaining3[ni], "int64"))
        assert np.array_equal(keep.numpy(), np.asarray(j_keep))
        assert rank.numpy().dtype == np.asarray(j_rank).dtype
        assert np.array_equal(rank.numpy(), np.asarray(j_rank))


def test_eviction_degenerate_shapes():
    """Nothing eligible, and identical candidates whose exact ties fall
    to greedy order (tests/test_preempt_kernels.py:127)."""
    case = ([100, 100, 100], np.array([[0, 0, 0]], np.int64),
            np.array([[[50, 50, 50], [60, 60, 60]]], np.int64),
            np.array([[10, 10]], np.int32), np.zeros((1, 2), np.int64),
            np.array([[False, False]], bool))
    got, sel_ord, met = _torch_eviction_set(*case)
    assert got == [None]
    assert np.array_equal(sel_ord, _jnp_greedy(*case)[0])
    res3 = np.array([[[40, 40, 40]] * 4], np.int64)
    case = ([100, 100, 100], np.array([[0, 0, 0]], np.int64), res3,
            np.full((1, 4), 20, np.int32), np.zeros((1, 4), np.int64), np.ones((1, 4), bool))
    got, sel_ord, _ = _torch_eviction_set(*case)
    want = preempt.select_eviction_set_py([100, 100, 100], [0, 0, 0], res3[0], [20] * 4,
                                          [0] * 4, [True] * 4)
    assert got[0] == want == [0, 1, 2]
    assert np.array_equal(sel_ord, _jnp_greedy(*case)[0])


# -- the plain scan's has_pre branch against the JAX scan ---------------------------


def _jax_run(scan, n_pad, static, carry, xs):
    conv = lambda arrs: tuple(_jnp(a) for a in arrs)  # noqa: E731
    jc, jy = scan(n_pad, conv(static), conv(carry), conv(xs))
    return [np.asarray(a) for a in jc], [np.asarray(a) for a in jy]


def _torch_run(n_pad, static, carry, xs, stats=None):
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    if stats is None:
        tc, ty = kernels.place_scan(n_pad, st, ca, x)
    else:
        tc, ty = step.place_scan(n_pad, st, ca, x, stats)
    return convert.to_numpy(tc), convert.to_numpy(ty)


def _assert_same(jax_out, torch_out):
    (jc, jy), (tc, ty) = jax_out, torch_out
    names = ("chosen", "scores", "pulls", "skipped", "evict")
    for name, a, b in zip(names, jy, ty):
        if name == "evict":
            assert a.dtype == np.int64 and b.dtype == np.int32
        else:
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.array_equal(a, b), (name, np.nonzero(a != b)[0][:8])
    for i, (a, b) in enumerate(zip(jc, tc)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        assert np.array_equal(a, b), f"final carry entry {i} differs"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", PREEMPT_VARIANTS)
def test_plain_has_pre_scan_bit_identical_to_jax(jax_scan, variant, seed):
    n_pad, static, carry, xs = example_scan_variant(
        variant, n_nodes=90 + 30 * seed, n_tgs=3, n_placements=40, seed=seed)
    assert static[20].shape[1] == preempt.C_MAX
    jax_out = _jax_run(jax_scan, n_pad, static, carry, xs)
    _assert_same(jax_out, _torch_run(n_pad, static, carry, xs))
    chosen, evict = jax_out[1][0], jax_out[1][4]
    assert (chosen >= 0).sum() > 0
    assert (evict >= 0).any(axis=1).sum() > 0, "the variant should evict"
    # the penalty, the pre_counts carry and pre_alive all moved
    assert not np.array_equal(jax_out[0][11], carry[11])
    assert not np.array_equal(jax_out[0][9], carry[9])


def test_greedy_skipped_where_it_cannot_matter(jax_scan):
    """The plain step (and the kernel) run the greedy only on rows where
    it can decide feasibility. On this variant the full sweep (the JAX
    step's) meets on rows that fit outright, where the port does not run
    it, and the outputs still equal the JAX scan's."""
    n_pad, static, carry, xs = example_scan_variant(
        "preempt", n_nodes=120, n_tgs=2, n_placements=30, seed=5)
    st = convert.to_torch(static, "cpu")
    ca = convert.to_torch(carry, "cpu")
    g = int(xs[0][0])
    ask3 = st[2][g, :3].to(I64)
    fits = ((ca[0] + st[2][g][None, :]) <= st[0]).all(dim=-1)
    pen = step._preempt_penalty(st[24], st[23], ca[11])
    _, met_all = preempt.greedy_select_t(ask3, st[20][:, :, :3].to(I64), st[21], pen,
                                         ca[9] & st[22], ca[10])
    assert bool((met_all & fits).any()), "the full sweep should meet on fitting rows"
    stats = {}
    jax_out = _jax_run(jax_scan, n_pad, static, carry, xs)
    _assert_same(jax_out, _torch_run(n_pad, static, carry, xs, stats))
    steps = int((~jax_out[1][3]).sum())
    assert 0 < stats["greedy_rows"] < steps * 120
    assert stats["second_pass_rows"] == int((jax_out[1][4] >= 0).any(axis=1).sum())


def test_float_arm_with_candidate_axis_raises():
    n_pad, static, carry, xs = example_scan_variant("s0", n_nodes=40, seed=1,
                                                    dtype=np.float32)
    static, carry = list(static), list(carry)
    static[20] = np.zeros((n_pad, 1, 4), np.int32)  # pre_res with C = 1
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    with pytest.raises(ValueError, match="int arm only"):
        kernels.place_scan(n_pad, st, ca, x)
    with pytest.raises(ValueError, match="int arm only"):
        example_scan_variant("preempt", n_nodes=40, dtype=np.float32)


def test_preempt_work_counts_the_greedy():
    """place_scan_work adds the preemption work the plain version counted
    and refuses a candidate axis without it."""
    n_pad, static, carry, xs = example_scan_variant("preempt", n_nodes=60, n_placements=12,
                                                    seed=3)
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    stats = {}
    _, ys = step.place_scan(n_pad, st, ca, x, stats)
    with pytest.raises(ValueError, match="preemption stats"):
        kernels.place_scan_work(st, ca, x, ys[3])
    nb, ops = kernels.place_scan_work(st, ca, x, ys[3], stats)
    nb0, ops0 = kernels.place_scan_work(st, ca, x, ys[3], {})
    assert stats["greedy_keys"] > 0
    assert ops - ops0 >= kernels.PRE_KEY_OPS * stats["greedy_keys"]
    assert nb == nb0
