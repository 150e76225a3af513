"""The float32 arm of the port's plain scan (nomad_tpu_torch/tpu/step.py,
reached through kernels.place_scan on CPU tensors) held against the JAX
float32 scan ``nomad_tpu.tpu.engine._build_place_scan``.

Inputs are numpy arrays made from a seed (``example_scan_variant`` with
``dtype=np.float32``), one variant per specialization axis of the step;
both sides get the same arrays. ``pow(10, x)`` is not bit-equal between
XLA's CPU backend and PyTorch's, so the check is the one stated in
``nomad_tpu_torch.tpu.parity``: per-task-group placement-multiset
divergence of the chosen nodes at most ``FLOAT_DIVERGENCE_BOUND`` (0 on
these seeds), and where both pick the same node, scores within
``FLOAT_SCORE_TOL`` (1e-5). Pulls and skipped flags are compared
exactly, as are the integer carries; float carries within the same
tolerance.
"""
import numpy as np
import pytest

from nomad_tpu.tpu.engine import _build_batched_scan, _build_place_scan

from nomad_tpu_torch.tpu import convert, kernels, parity, step
from nomad_tpu_torch.tpu.engine import SCAN_VARIANTS, example_scan_variant

@pytest.fixture(scope="module")
def jax_scan():
    return _build_place_scan()


def _jax_run(scan, n_pad, static, carry, xs):
    import jax.numpy as jnp

    conv = lambda arrs: tuple(jnp.asarray(a) for a in arrs)  # noqa: E731
    jc, jy = scan(n_pad, conv(static), conv(carry), conv(xs))
    return [np.asarray(a) for a in jc], [np.asarray(a) for a in jy]


def _torch_run(n_pad, static, carry, xs):
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    tc, ty = kernels.place_scan(n_pad, st, ca, x)
    return list(convert.to_numpy(tc)), list(convert.to_numpy(ty))


def float_check(ref, got, tg_idx):
    """The stated check (``parity.check_float_scan``) with float32 scores."""
    assert ref[1][1].dtype == got[1][1].dtype == np.float32
    return parity.check_float_scan(ref, got, tg_idx)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", SCAN_VARIANTS)
def test_float_plain_scan_matches_jax(jax_scan, variant, seed):
    n_pad, static, carry, xs = example_scan_variant(
        variant, n_nodes=96 + 40 * seed, n_tgs=3, n_placements=40, seed=seed,
        dtype=np.float32)
    ref = _jax_run(jax_scan, n_pad, static, carry, xs)
    float_check(ref, _torch_run(n_pad, static, carry, xs), xs[0])
    if variant != "overcommit":
        assert (ref[1][0] >= 0).sum() > 0


def test_float_batched_matches_jax_batched():
    """K3 in the float arm: three evals of equal padded shapes in one
    batched call, each within the bound of the JAX batched scan."""
    import jax.numpy as jnp

    evals = [example_scan_variant("all", n_nodes=80, n_tgs=2, n_placements=24,
                                  seed=s, dtype=np.float32)[1:] for s in (7, 8, 9)]
    stack = lambda k: tuple(np.stack(col) for col in zip(*(e[k] for e in evals)))  # noqa: E731
    static_b, carry_b, xs_b = stack(0), stack(1), stack(2)
    jc, jy = _build_batched_scan()(
        *(tuple(jnp.asarray(a) for a in arrs) for arrs in (static_b, carry_b, xs_b)))
    st, ca, x = convert.scan_inputs_to_torch(static_b, carry_b, xs_b, "cpu")
    tc, ty = kernels.place_scan_batched(st, ca, x)
    tc, ty = convert.to_numpy(tc), convert.to_numpy(ty)
    for b in range(3):
        float_check(([np.asarray(a)[b] for a in jc], [np.asarray(a)[b] for a in jy]),
                    ([a[b] for a in tc], [a[b] for a in ty]), xs_b[0][b])


def test_injected_perturbation_breaks_the_check(jax_scan, monkeypatch):
    """The check has teeth: +1e-3 on the score of the node the JAX scan
    picks first (a binpack-sized nudge) moves picks or scores past the
    stated bounds."""
    n_pad, static, carry, xs = example_scan_variant(
        "s1", n_nodes=96, n_tgs=3, n_placements=40, seed=0, dtype=np.float32)
    ref = _jax_run(jax_scan, n_pad, static, carry, xs)
    float_check(ref, _torch_run(n_pad, static, carry, xs), xs[0])
    node = int(ref[1][0][0])
    orig = step._score_float

    def nudged(*args, **kwargs):
        final, neg_inf = orig(*args, **kwargs)
        final = final.clone()
        final[node] += 1e-3
        return final, neg_inf

    monkeypatch.setattr(step, "_score_float", nudged)
    with pytest.raises(AssertionError):
        float_check(ref, _torch_run(n_pad, static, carry, xs), xs[0])


@pytest.mark.parametrize("scenario", ["affinities", "scale_up_down", "spread",
                                      "even_spread", "distinct_property"])
def test_float_plain_scan_on_jax_encoded_evals(scenario, monkeypatch):
    """The arrays the JAX engine's own float encode builds for a Harness
    scenario (non-deterministic evals), run through the port's scan,
    stay within the bound of the JAX scan's outputs."""
    import random

    from nomad_tpu.tpu.engine import TpuPlacementEngine

    import test_torch_engine as te

    seen = []
    orig = TpuPlacementEngine.run_scan_single

    def capture(self, enc):
        out = orig(self, enc)
        seen.append((enc.n_pad, enc.static, enc.carry, enc.xs, out))
        return out

    monkeypatch.setattr(TpuPlacementEngine, "run_scan_single", capture)
    monkeypatch.setattr(te, "register", te.register_float)
    random.seed(7)
    te.SCENARIOS[scenario](te.JAX, te.new_harness(te.JAX))
    assert seen
    for n_pad, static, carry, xs, jax_ys in seen:
        assert static[0].dtype == np.float32
        ref = ([np.asarray(a) for a in carry], [np.asarray(a) for a in jax_ys])
        got = _torch_run(n_pad, static, carry, xs)
        # the JAX outputs are only (chosen, scores, pulls, skipped, evict):
        # compare the step outputs; the carry is checked by the variants
        (_, ry), (_, gy) = ref, got
        assert parity.tg_multiset_divergence(gy[0], ry[0], xs[0]) <= parity.FLOAT_DIVERGENCE_BOUND
        _, diff = parity.score_diff_at_equal_picks(ry[0], ry[1], gy[0], gy[1])
        assert diff <= parity.FLOAT_SCORE_TOL
