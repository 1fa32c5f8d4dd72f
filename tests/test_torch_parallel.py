"""The port's mesh, collectives and halo exchange (``parallel/mesh.py``,
``collectives.py``, ``halo.py``, ``launch.py``) against the JAX package's
``parallel/mesh.py`` and ``halo.py`` on the conftest's 8 virtual CPU devices.

The port's ranks are spawned CPU processes joined by gloo
(``run_ranks``); their functions live in ``tests/torch_mesh_cases.py``.
Tolerances: the halo box filter equals the global one and JAX's within rtol
1e-6 (tests/test_sharded.py:82); mesh shapes, group ranks and collective
results are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from rpg_open_remode_tpu.parallel import exchange_halo_2d as jax_halo_2d
from rpg_open_remode_tpu.parallel import make_mesh as jax_make_mesh
from rpg_open_remode_tpu.parallel.mesh import _factor3 as jax_factor3
from rpg_open_remode_tpu.utils.interp import box_sum as jax_box_sum
from rpg_open_remode_tpu_torch.parallel import join_state_numpy, run_ranks, split_state_numpy
from rpg_open_remode_tpu_torch.parallel.collectives import backend_for
from rpg_open_remode_tpu_torch.parallel.mesh import _factor3, assemble_tiles, mesh_shape

import torch_mesh_cases

torch.set_num_threads(2)
SHAPE = (1, 2, 2)


@pytest.fixture(scope="module")
def suite():
    """One (1, 2, 2) world of 4 gloo ranks running the collectives suite on
    a numpy-seeded 16x24 field."""
    x = np.random.default_rng(0).random((16, 24)).astype(np.float32)
    return x, run_ranks(torch_mesh_cases.collectives_suite, SHAPE, (x,), device="cpu",
                      timeout=300)


@pytest.mark.parametrize("n", range(1, 9))
def test_factor3_and_mesh_shapes_match_jax(n):
    assert _factor3(n) == jax_factor3(n)
    for kw in ({}, {"kf": 2}, {"kf": 1, "ty": 1}):
        try:
            m = jax_make_mesh(n, **kw)
            want = (m.shape["kf"], m.shape["ty"], m.shape["tx"])
        except ValueError:
            with pytest.raises(ValueError):
                mesh_shape(n, **kw)
            continue
        assert mesh_shape(n, **kw) == want, kw


def test_halo_box_filter_matches_global_and_jax(suite):
    x, out = suite
    got = assemble_tiles([torch.tensor(o["box"]) for o in out], SHAPE[2]).numpy()
    want = np.asarray(jax_box_sum(jnp.asarray(x), 5, -2))
    np.testing.assert_allclose(got, want, rtol=1e-6)

    def tile_fn(xt):
        ext = jax_halo_2d(xt, 2)
        s = lax.reduce_window(ext, 0.0, lax.add, (1, 5), (1, 1), "valid")
        return lax.reduce_window(s, 0.0, lax.add, (5, 1), (1, 1), "valid")

    mesh = jax_make_mesh(4, kf=1, ty=2, tx=2)
    jgot = jax.jit(jax.shard_map(tile_fn, mesh=mesh, in_specs=JP("ty", "tx"),
                                 out_specs=JP("ty", "tx")))(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-6)


def test_mesh_coords_groups_and_default_shapes(suite):
    _, out = suite
    assert [o["coords"] for o in out] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    # no group for the kf axis of size 1: its collectives are the identity
    assert all(o["groups"] == ["sp", "tx", "ty"] for o in out)
    assert all(o["default_shape"] == (1, 2, 2) for o in out)
    # kf-major over two hosts: kf defaults to the hosts, whole rows per host
    assert [o["distributed"] for o in out] == [((2, 1, 2), h) for h in (0, 0, 1, 1)]
    assert all(o["staged"] == {"copies": 0, "bytes": 0} for o in out)


def test_feeding_a_rank(suite):
    """``replicate_frame`` gives every rank the frame; ``shard_local_keyframes``
    its tile of each of its row's keyframes, every field cut alike."""
    x, out = suite
    for o in out:
        _, y, xx = o["coords"]
        fed = o["fed"]
        np.testing.assert_array_equal(fed["frame"], x)
        rows, cols = slice(8 * y, 8 * y + 8), slice(12 * xx, 12 * xx + 12)
        np.testing.assert_array_equal(fed["mu"], x[rows, cols])
        np.testing.assert_array_equal(fed["conv"], (x[rows, cols] > 0.5).astype(np.int32))
        np.testing.assert_array_equal(fed["f_ref"], fed["f_ref_full"][:, rows, cols])


def test_all_reduce_over_each_axis(suite):
    _, out = suite
    for r, o in enumerate(out):
        s = o["sums"]
        k, y, x = o["coords"]
        row = [1 + 2 * y + i for i in range(2)]      # tx line through (y, .)
        col = [1 + x + 2 * i for i in range(2)]      # ty line through (., x)
        assert s["sum"] == {"world": 10.0, "kf": r + 1.0, "ty": sum(col), "tx": sum(row),
                            "sp": 10.0}
        assert s["max"] == {"world": 4.0, "kf": r + 1.0, "ty": max(col), "tx": max(row),
                            "sp": 4.0}
        assert s["min"] == {"world": 1.0, "kf": r + 1.0, "ty": min(col), "tx": min(row),
                            "sp": 1.0}


def test_gathers_follow_band_order(suite):
    _, out = suite
    assert all(o["all_gather_sp"] == [1.0, 2.0, 3.0, 4.0] for o in out)
    assert out[0]["gather_sp"] == [1.0, 2.0, 3.0, 4.0]
    assert all(o["gather_sp"] is None for o in out[1:])


def test_permute_and_halo_edges(suite):
    _, out = suite
    # tx ring of two: each rank receives the other's value
    assert [o["ring"] for o in out] == [2.0, 1.0, 4.0, 3.0]
    for r, o in enumerate(out):
        h = o["halo_ty"]
        y = o["coords"][1]
        # the rows from the ty neighbour, or the own edge at the border
        above = r if y == 0 else r - 2
        below = r if y == 1 else r + 2
        np.testing.assert_array_equal(h[0], np.full(3, above))
        np.testing.assert_array_equal(h[-1], np.full(3, below))
        np.testing.assert_array_equal(h[1:-1], np.full((2, 3), r))


def test_failed_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*fails on purpose"):
        run_ranks(torch_mesh_cases.fail_on, (1, 1, 2), (1,), device="cpu", timeout=120)


def test_ranks_want_cuda_unless_asked_for_the_cpu(monkeypatch):
    """Without a device the ranks go on CUDA, and without CUDA the launch
    raises before any rank starts, as the single-device engine does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(torch_mesh_cases.fail_on, (1, 1, 2), (1,), timeout=120)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 2), (2, 1, 2), (4, 2, 1)])
def test_split_and_join_state_numpy(shape):
    """The carry-across helper: a batched state split into every rank's
    tiles and joined back is the same state."""
    rng = np.random.default_rng(1)
    kf = 4
    arrays = {name: rng.random((kf, 8, 12)).astype(np.float32)
              for name in ("mu", "sigma_sq", "conv")}
    arrays["f_ref"] = rng.random((kf, 3, 8, 12)).astype(np.float32)
    arrays["T_world_ref"] = rng.random((kf, 3, 4)).astype(np.float32)
    arrays["scene"] = {"avg_depth": rng.random(kf).astype(np.float32)}
    n = int(np.prod(shape))
    parts = [split_state_numpy(arrays, shape, r) for r in range(n)]
    assert parts[0]["mu"].shape == (kf // shape[0], 8 // shape[1], 12 // shape[2])
    back = join_state_numpy(parts, shape)
    for name in ("mu", "sigma_sq", "conv", "f_ref", "T_world_ref"):
        np.testing.assert_array_equal(back[name], arrays[name])
    np.testing.assert_array_equal(back["scene"]["avg_depth"], arrays["scene"]["avg_depth"])


def test_backend_follows_the_layout(monkeypatch):
    assert backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert backend_for("cuda", 4) == "nccl"
    assert backend_for("cuda", 1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend_for("cuda", 4) == "gloo"
