"""The port's plain PyTorch scan (nomad_tpu_torch/tpu/step.py, reached
through kernels.place_scan on CPU tensors) held against the JAX scan
``nomad_tpu.tpu.engine._build_place_scan`` bit for bit.

Inputs are numpy arrays made from a seed (``example_scan_variant``), one
variant per specialization axis of the step; both sides get the same
arrays (nomad_tpu_torch.tpu.convert). Compared: chosen, scores, pulls,
skipped, evict and the whole final carry, values and dtypes. Tolerance:
none (the int arm is exact).
"""
import numpy as np
import pytest
import torch

from nomad_tpu.tpu.engine import _build_batched_scan, _build_place_scan

from nomad_tpu_torch.tpu import convert, kernels
from nomad_tpu_torch.tpu.engine import SCAN_VARIANTS, example_scan_variant
from nomad_tpu_torch.tpu.intscore import PACK_COUNT_MAX


@pytest.fixture(scope="module")
def jax_scan():
    # builds the scan first: it turns on x64 before any array converts
    return _build_place_scan()


def _jax_run(scan, n_pad, static, carry, xs):
    import jax.numpy as jnp

    conv = lambda arrs: tuple(jnp.asarray(a) for a in arrs)  # noqa: E731
    jc, jy = scan(n_pad, conv(static), conv(carry), conv(xs))
    return [np.asarray(a) for a in jc], [np.asarray(a) for a in jy]


def _torch_run(n_pad, static, carry, xs):
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    tc, ty = kernels.place_scan(n_pad, st, ca, x)
    return convert.to_numpy(tc), convert.to_numpy(ty)


def _assert_same(jax_out, torch_out):
    (jc, jy), (tc, ty) = jax_out, torch_out
    names = ("chosen", "scores", "pulls", "skipped", "evict")
    for name, a, b in zip(names, jy, ty):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.array_equal(a, b), (name, np.nonzero(a != b)[0][:8])
    for i, (a, b) in enumerate(zip(jc, tc)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        assert np.array_equal(a, b), f"final carry entry {i} differs"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", SCAN_VARIANTS)
def test_plain_scan_bit_identical_to_jax(jax_scan, variant, seed):
    n_pad, static, carry, xs = example_scan_variant(
        variant, n_nodes=96 + 40 * seed, n_tgs=3, n_placements=40, seed=seed)
    jax_out = _jax_run(jax_scan, n_pad, static, carry, xs)
    _assert_same(jax_out, _torch_run(n_pad, static, carry, xs))
    if variant != "overcommit":
        assert (jax_out[1][0] >= 0).sum() > 0


def test_overcommit_variant_fails_and_skips(jax_scan):
    """The overcommit variant reaches the failure, skip and revert paths."""
    n_pad, static, carry, xs = example_scan_variant(
        "overcommit", n_nodes=64, n_tgs=2, n_placements=64, seed=3)
    jax_out = _jax_run(jax_scan, n_pad, static, carry, xs)
    _assert_same(jax_out, _torch_run(n_pad, static, carry, xs))
    chosen, skipped = jax_out[1][0], jax_out[1][3]
    assert (chosen < 0).sum() > 0 and skipped.sum() > 0


def test_plain_scan_at_n_pad_above_pack_count_max(jax_scan):
    """n_pad >= PACK_COUNT_MAX takes the two plain ring cumsums."""
    n_pad, static, carry, xs = example_scan_variant(
        "s1", n_nodes=PACK_COUNT_MAX + 200, n_tgs=2, n_placements=4, seed=5)
    assert n_pad >= PACK_COUNT_MAX
    _assert_same(_jax_run(jax_scan, n_pad, static, carry, xs),
                 _torch_run(n_pad, static, carry, xs))


def test_batched_scan_matches_jax_batched(jax_scan):
    """K3: two evals of equal padded shapes in one batched call."""
    import jax.numpy as jnp

    evals = [example_scan_variant("all", n_nodes=80, n_tgs=2, n_placements=24,
                                  seed=s)[1:] for s in (7, 8)]
    stack = lambda k: tuple(np.stack(col) for col in zip(*(e[k] for e in evals)))  # noqa: E731
    static_b, carry_b, xs_b = stack(0), stack(1), stack(2)
    jc, jy = _build_batched_scan()(
        *(tuple(jnp.asarray(a) for a in arrs) for arrs in (static_b, carry_b, xs_b)))
    st, ca, x = convert.scan_inputs_to_torch(static_b, carry_b, xs_b, "cpu")
    tc, ty = kernels.place_scan_batched(st, ca, x)
    _assert_same(([np.asarray(a) for a in jc], [np.asarray(a) for a in jy]),
                 (convert.to_numpy(tc), convert.to_numpy(ty)))


def test_wrapper_updates_carry_in_place():
    n_pad, static, carry, xs = example_scan_variant("s1", n_nodes=40, seed=4)
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    used0 = ca[0].clone()
    out_carry, _ = kernels.place_scan(n_pad, st, ca, x)
    assert all(a is b for a, b in zip(out_carry, ca))
    assert not torch.equal(ca[0], used0)


def test_other_dtypes_raise():
    """The scan has an int32 and a float32 arm; a float64 encode raises."""
    n_pad, static, carry, xs = example_scan_variant("s0", n_nodes=40, seed=1)
    static = list(static)
    static[0] = static[0].astype(np.float64)
    st, ca, x = convert.scan_inputs_to_torch(static, carry, xs, "cpu")
    with pytest.raises(NotImplementedError, match="float32 arm"):
        kernels.place_scan(n_pad, st, ca, x)


def test_convert_keeps_dtypes_and_copies():
    n_pad, static, carry, xs = example_scan_variant("all", n_nodes=40, seed=2)
    st = convert.to_torch(static, "cpu")
    for a, t in zip(static, st):
        assert convert.to_numpy([t])[0].dtype == np.asarray(a).dtype
        assert t.shape == np.asarray(a).shape
    st[0].add_(1)
    assert not np.array_equal(static[0], st[0].numpy())


def test_cpu_scan_launches_no_kernel():
    kernels.reset_launch_counts()
    n_pad, static, carry, xs = example_scan_variant("s1", n_nodes=40, seed=6)
    _torch_run(n_pad, static, carry, xs)
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}
    assert set(kernels.LAUNCHES) == {"place_scan", "place_scan_f32", "place_scan_has_pre",
                                     "forced_eval", "forced_eval_f32", "chunk_scan"}


@pytest.mark.parametrize("scenario", ["affinities", "scale_up_down", "distinct_property",
                                      "even_spread", "overcommitted"])
def test_plain_scan_on_jax_encoded_evals(scenario, monkeypatch):
    """The arrays the JAX engine's own encode_eval builds for a Harness
    scenario (test_torch_engine.py), carried across with convert and run
    through the port's scan, give the JAX scan's outputs."""
    from nomad_tpu.tpu.engine import TpuPlacementEngine

    from test_torch_engine import JAX, SCENARIOS, new_harness

    seen = []
    orig = TpuPlacementEngine.run_scan_single

    def capture(self, enc):
        out = orig(self, enc)
        seen.append((enc.n_pad, enc.static, enc.carry, enc.xs, out))
        return out

    monkeypatch.setattr(TpuPlacementEngine, "run_scan_single", capture)
    SCENARIOS[scenario](JAX, new_harness(JAX))
    assert seen
    for n_pad, static, carry, xs, jax_ys in seen:
        _, torch_ys = _torch_run(n_pad, static, carry, xs)
        for a, b in zip(jax_ys, torch_ys):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """A library's build key hashes its source and every csrc/ header it
    includes: editing the shared header rebuilds every library, editing
    one source only its own."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "SOURCES", {
        name: csrc / path.name for name, path in kernels.SOURCES.items()})
    names = sorted(kernels.SOURCES)
    assert names == ["chunk_scan", "forced_eval", "place_scan"]
    for name in names:
        assert csrc / "common.cuh" in kernels._compiled_files(kernels.SOURCES[name])
    before = {name: kernels._lib_path(name) for name in names}
    header = csrc / "common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: kernels._lib_path(name) for name in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "forced_eval.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    again = {name: kernels._lib_path(name) for name in names}
    assert again["place_scan"] == after["place_scan"]
    assert again["chunk_scan"] == after["chunk_scan"]
    assert again["forced_eval"] != after["forced_eval"]
