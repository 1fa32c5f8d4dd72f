"""The port's host IO against the JAX package's: the dataset reader, the
native library and its numpy versions, point clouds, the global map, the
convergence overlay and its PNG, and checkpoints in both directions."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rpg_open_remode_tpu import io as jio
from rpg_open_remode_tpu import native as jnative
from rpg_open_remode_tpu.models.state import SceneParams as JScene, SeedState as JState
from rpg_open_remode_tpu.utils import synthetic
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch import io as pio
from rpg_open_remode_tpu_torch import native as pnative
from rpg_open_remode_tpu_torch.io.png import encode_png, write_png
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
GOLD = Path(__file__).resolve().parent / "data" / "golden_dataset"
SEQ = "first_2_frames_sequence.txt"
H, W = 48, 64


@pytest.fixture(scope="module")
def arrays():
    """A seeded state's leaves: random image, depth, variance and Beta
    evidence, conv states over all five values, a rigid keyframe pose."""
    rng = np.random.default_rng(7)
    cam = PinholeCamera.create(60.0, -59.0, 31.5, 23.5, device="cpu")
    angle = 0.3
    c, s = np.cos(angle), np.sin(angle)
    T = np.array([[c, 0, s, 0.2], [0, 1, 0, -0.1], [-s, 0, c, 0.4]], np.float32)
    scene = {k: np.asarray(v, np.float32) for k, v in dict(
        min_depth=0.8, max_depth=2.9, avg_depth=1.85, depth_range=2.1,
        sigma_sq_max=2.1 ** 2 / 36, epsilon=2.1e-3).items()}
    img = rng.random((H, W), dtype=np.float32)
    return dict(
        ref_img=img, sum_templ=25 * img, const_templ_denom=rng.random((H, W), dtype=np.float32),
        f_ref=cam.bearing_grid(H, W).numpy(),
        mu=rng.uniform(0.8, 2.9, (H, W)).astype(np.float32),
        sigma_sq=rng.uniform(1e-4, 0.1, (H, W)).astype(np.float32),
        a=rng.uniform(5, 30, (H, W)).astype(np.float32),
        b=rng.uniform(5, 30, (H, W)).astype(np.float32),
        conv=rng.integers(0, 6, (H, W)).astype(np.int32),
        match_u=rng.random((H, W), dtype=np.float32),
        match_v=rng.random((H, W), dtype=np.float32),
        T_world_ref=T, scene=scene)


def _jax_state(a):
    scene = JScene(**{k: jnp.asarray(v) for k, v in a["scene"].items()})
    return JState(scene=scene, **{k: jnp.asarray(v) for k, v in a.items() if k != "scene"})


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "scene":
            _assert_states_equal(got[k], want[k])
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- dataset ---------------------------------------------------------------------


def test_dataset_parse_and_poses_equal_jax():
    """The golden dataset's blank, short and trailing-token lines, its PGM
    and PNG images and its tab/scientific-notation depth files."""
    want, got = jio.Dataset(SEQ, path=str(GOLD)), pio.Dataset(SEQ, path=str(GOLD))
    assert want.read_data_sequence() and got.read_data_sequence()
    assert [e.image_file for e in got] == ["frame_000.pgm", "frame_001.png", "frame_002.pgm"]
    assert len(got) == len(want)
    for e_got, e_want in zip(got, want):
        assert (e_got.image_file, e_got.depthmap_file) == (e_want.image_file, e_want.depthmap_file)
        np.testing.assert_array_equal(e_got.T_world_curr, e_want.T_world_curr)
        np.testing.assert_array_equal(e_got.T_curr_world, e_want.T_curr_world)
        np.testing.assert_array_equal(got.read_image(e_got), want.read_image(e_want))
    for i in (0, 2):
        depth = got.read_depthmap(got[i], 8, 6)
        np.testing.assert_array_equal(depth, want.read_depthmap(want[i], 8, 6))
        np.testing.assert_allclose(depth, np.load(GOLD / f"expected_depth{i}.npy"), rtol=1e-6)
    for i in range(3):
        np.testing.assert_array_equal(got.read_image(got[i]), np.load(GOLD / f"expected_img{i}.npy"))
    with pytest.raises(FileNotFoundError):
        got.read_depthmap(got[1], 8, 6)


def test_frame_prefetcher_yields_every_frame():
    ds = pio.Dataset(SEQ, path=str(GOLD))
    assert ds.read_data_sequence()
    pf = pio.FramePrefetcher(ds, depth=1, gt_shape=(8, 6))
    try:
        got = list(pf)
    finally:
        pf.close()
    assert [e.image_file for e, _, _ in got] == [e.image_file for e in ds]
    assert got[0][2].shape == (6, 8) and got[1][1].shape == (6, 8)


# -- native library and numpy versions --------------------------------------------


def test_native_builds_here():
    assert pnative.backend() == "native"


def test_native_and_numpy_read_the_same(tmp_path):
    # the port reads PGM with numpy only; the JAX package's native reader
    # decodes the same pixels, also past a comment line and a split header
    commented = tmp_path / "commented.pgm"
    pixels = np.arange(35, dtype=np.uint8).reshape(5, 7)
    commented.write_bytes(b"P5\n# a comment\n7\n5 255\n" + pixels.tobytes())
    for pgm in (str(GOLD / "images" / "frame_000.pgm"), str(commented)):
        np.testing.assert_array_equal(pnative.read_pgm(pgm), jnative.read_pgm(pgm))
    np.testing.assert_array_equal(pnative.read_pgm(str(commented)), pixels)
    depth = str(GOLD / "depthmaps" / "frame_002.depth")
    for scale in (1.0, 0.01):
        got = pnative.parse_float_file(depth, 48, scale)
        np.testing.assert_array_equal(got, pnative.parse_float_file_numpy(depth, 48, scale))
        np.testing.assert_array_equal(got, jnative.parse_float_file(depth, 48, scale))
    with pytest.raises(ValueError):
        pnative.parse_float_file(depth, 10_000)
    with pytest.raises(FileNotFoundError):
        pnative.parse_float_file(str(tmp_path / "missing.depth"), 4)


def test_ply_bytes_equal_numpy_and_jax_writers(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(257, 3)).astype(np.float32)
    inten = rng.random(257, dtype=np.float32)
    paths = {k: str(tmp_path / f"{k}.ply") for k in ("port", "jax")}
    pnative.write_ply(paths["port"], xyz, inten)
    jnative.write_ply(paths["jax"], xyz, inten)   # the JAX package's native writer
    data = {k: Path(p).read_bytes() for k, p in paths.items()}
    assert data["port"] == data["jax"]
    assert data["port"].startswith(b"ply\nformat binary_little_endian 1.0\nelement vertex 257\n")
    assert len(data["port"]) == len(data["port"].split(b"end_header\n")[0]) + 11 + 257 * 16


# -- point clouds, global map, overlay --------------------------------------------


def test_backproject_converged_equals_jax(arrays):
    jstate, pstate = _jax_state(arrays), P.state_from_numpy(arrays, device="cpu")
    depth = arrays["mu"] * 1.01
    for d in (None, depth):
        want = jio.backproject_converged(jstate, d)
        got = pio.backproject_converged(pstate, d)
        assert got[0].shape == want[0].shape and got[0].shape[0] > 0
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])


def test_voxel_downsample_equals_jax():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)
    inten = rng.random(500, dtype=np.float32)
    w = rng.uniform(1, 3, 500)
    for got, want in ((pio.voxel_downsample(xyz, inten, 0.1), jio.voxel_downsample(xyz, inten, 0.1)),
                      (pio.voxel_downsample(xyz, inten, 0.1, weights=w),
                       jio.voxel_downsample(xyz, inten, 0.1, weights=w))):
        assert len(got) == len(want)
        for g, v in zip(got, want):
            np.testing.assert_array_equal(g, v)


def test_global_map_fusion_equals_jax(arrays, tmp_path):
    results = []
    for shift in (0.0, 0.004):
        a = dict(arrays, mu=arrays["mu"] + shift)
        results.append((_jax_state(a), P.state_from_numpy(a, device="cpu"), a["mu"] * 0.99))
    jmap, pmap = jio.GlobalMap(voxel=0.05), pio.GlobalMap(voxel=0.05)
    for jst, pst, den in results:
        jmap.add_keyframe(type("R", (), dict(state=jst, denoised_depth=den)))
        pmap.add_keyframe(type("R", (), dict(state=pst, denoised_depth=den)))
    (gx, gi), (wx, wi) = pmap.cloud(), jmap.cloud()
    assert pmap.n_keyframes == 2 and gx.shape == wx.shape
    np.testing.assert_allclose(gx, wx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gi, wi, rtol=1e-6)
    assert pmap.save_ply(str(tmp_path / "map.ply")) == gx.shape[0]


def test_convergence_overlay_and_png_equal_jax(arrays, tmp_path):
    from PIL import Image

    got = pio.convergence_overlay(P.state_from_numpy(arrays, device="cpu"))
    want = jio.convergence_overlay(_jax_state(arrays))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    write_png(str(tmp_path / "overlay.png"), got)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "overlay.png")), want)
    odd = np.ascontiguousarray(got[:7, :5])
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(odd)))), odd)
    with pytest.raises(ValueError):
        encode_png(got[..., 0])


# -- checkpoints ------------------------------------------------------------------


def test_checkpoint_jax_to_port(arrays, tmp_path):
    path = str(tmp_path / "jax.npz")
    jio.save_state(path, _jax_state(arrays))
    got = P.state_to_numpy(pio.load_state(path, device="cpu"))
    _assert_states_equal(got, arrays)


def test_checkpoint_port_to_jax(arrays, tmp_path):
    path = str(tmp_path / "port.npz")
    pio.save_state(path, P.state_from_numpy(arrays, device="cpu"))
    _assert_states_equal(jax_state_numpy(jio.load_state(path)), arrays)
    with np.load(path) as data:
        assert int(data["format_version"]) == 1
        assert sorted(data.files) == sorted(
            ["format_version"] + [f"state.{k}" for k in arrays if k != "scene"]
            + [f"scene.{k}" for k in arrays["scene"]])


def test_load_state_default_device_is_cuda(arrays, tmp_path, monkeypatch):
    path = str(tmp_path / "port.npz")
    pio.save_state(path, P.state_from_numpy(arrays, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pio.load_state(path)


def test_resumed_engine_continues_bit_for_bit(tmp_path):
    cam = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
    frames = synthetic.generate(n_frames=8, width=160, height=120, cam=cam, seed=3)

    def Tcw(fr):
        T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
        return np.linalg.inv(T)[:3].astype(np.float32)

    def engine():
        return P.Depthmap(160, 120, cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                          cfg=P.RemodeConfig(num_planes=48), device="cpu")

    d0 = frames[0].depth[np.isfinite(frames[0].depth)]
    a = engine()
    a.set_reference_image(frames[0].image, Tcw(frames[0]), d0.min(), d0.max())
    for fr in frames[1:6]:
        a.update(fr.image, Tcw(fr))
    path = str(tmp_path / "kf.npz")
    pio.save_state(path, a.state)
    b = engine()
    b.restore(pio.load_state(path, device="cpu"))
    for fr in frames[6:]:
        a.update(fr.image, Tcw(fr))
        b.update(fr.image, Tcw(fr))
    _assert_states_equal(P.state_to_numpy(b.state), P.state_to_numpy(a.state))
