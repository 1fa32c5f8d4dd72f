"""The CUDA kernels against their plain PyTorch versions, on the card.

The ``cuda``-marked tests need a GPU with nvcc and skip elsewhere;
on the CPU the wrappers run the plain versions, which the other
test_torch_* files hold against the JAX package.
"""

import numpy as np
import pytest
import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.ops import denoise, denoise_cuda, resample_cuda, sweep_cuda
from rpg_open_remode_tpu_torch.testing import sweep_cases

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def uniform_bands(rng, patch_side):
    h, w, pad = 128, 512, 128
    ref = rng.random((h, w), dtype=np.float32)
    curr = rng.random((h, w + 2 * pad), dtype=np.float32)
    curr[:, pad - 20: pad - 20 + w] = 0.5 * curr[:, pad - 20: pad - 20 + w] + 0.5 * ref
    valid = np.ones((h, w), np.float32)
    valid[:, :7] = 0.0
    xlim = np.tile(np.array([[-50.0, w + 50.0]], np.float32), (h, 1))
    lo = rng.uniform(0, 60, (h, w)).astype(np.float32)
    hi = lo + rng.uniform(0, 70, (h, w)).astype(np.float32)
    lo[:10], hi[:10] = np.inf, -np.inf
    return (curr, xlim, ref, valid, lo, hi), 127, 128


# name -> (rng, patch_side) -> (inputs, planes, pad). 'edge cases' are
# testing/sweep_cases.edge_cases (ties, a best at a band's ends, masked
# neighbours, bands at plane 0 and K-1, empty, infinite and NaN bands,
# footprint cuts); 'ragged' the main-path rect grids of 640x480 (512x768)
# and 1280x720 (768x1408), full and half-width coarse.
SWEEP_INPUTS = {
    "uniform bands": uniform_bands,
    "edge cases": lambda rng, p: (sweep_cases.edge_cases(p), 127, 128),
    "ragged 512x768": lambda rng, p: (sweep_cases.ragged_bands(rng, 512, 768, 128, 127), 127, 128),
    "ragged coarse 512x384": lambda rng, p: (sweep_cases.ragged_bands(rng, 512, 384, 64, 63), 63, 64),
    "ragged 768x1408": lambda rng, p: (sweep_cases.ragged_bands(rng, 768, 1408, 256, 255), 255, 256),
    "ragged coarse 768x704": lambda rng, p: (sweep_cases.ragged_bands(rng, 768, 704, 128, 127),
                                             127, 128),
    # 1920x1080 at for_camera(1443.6): patch 15 (17 in its p17 row), a
    # 1152x2048 grid, pad 384, 383 planes; the coarse pass at half width
    "ragged 1152x2048": lambda rng, p: (sweep_cases.ragged_bands(rng, 1152, 2048, 384, 383),
                                        383, 384),
    "ragged coarse 1152x1024": lambda rng, p: (sweep_cases.ragged_bands(rng, 1152, 1024, 192,
                                                                        191), 191, 192),
}


@pytest.mark.cuda
@pytest.mark.parametrize("inputs,patch_side,refine", [
    ("uniform bands", 5, True), ("uniform bands", 9, True), ("uniform bands", 5, False),
    ("edge cases", 5, True), ("edge cases", 9, True), ("edge cases", 5, False),
    ("edge cases", 9, False), ("ragged 512x768", 5, True), ("ragged coarse 512x384", 5, False),
    ("ragged 768x1408", 9, True), ("ragged coarse 768x704", 9, False),
    ("edge cases", 15, True), ("edge cases", 17, True), ("edge cases", 15, False),
    ("edge cases", 17, False), ("ragged 1152x2048", 15, True), ("ragged 1152x2048", 17, True),
    ("ragged coarse 1152x1024", 15, False), ("ragged coarse 1152x1024", 17, False),
])
def test_sweep_kernel_matches_plain(dev, inputs, patch_side, refine):
    """The kernel equals the plain version bit for bit: disparity, NCC and
    found at every pixel."""
    arrays, planes, pad = SWEEP_INPUTS[inputs](np.random.default_rng(7), patch_side)
    args = [torch.tensor(a, device=dev) for a in arrays]
    before = kernels.LAUNCHES["sweep"]
    got = sweep_cuda.disparity_sweep(*args, 0.5, planes, pad, patch_side, refine)
    assert kernels.LAUNCHES["sweep"] == before + 1
    want = sweep_cuda.disparity_sweep_plain(*args, 0.5, planes, pad, patch_side, refine)
    assert int(want[2].sum()) > 100
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("patch_side,planes,want", [(5, 127, 24_584), (9, 255, 37_288),
                                                    (15, 383, 59_112), (17, 383, 63_848)])
def test_sweep_occupancy(dev, patch_side, planes, want):
    """The block's dynamic shared memory at the main path's configurations
    (past 48 KB at patch 15 and 17 with 383 planes, where the kernel opts
    in), and at least one block of it fits an SM."""
    occ = sweep_cuda.sweep_occupancy(patch_side, planes)
    assert occ["smem_bytes"] == want
    assert occ["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_sweep_lane_counts(dev):
    """The counting build gives the same result and counts whole warps:
    lanes that ran <= 32 per warp-step, and some of each loop ran."""
    arrays, planes, pad = SWEEP_INPUTS["ragged 512x768"](np.random.default_rng(7), 5)
    args = [torch.tensor(a, device=dev) for a in arrays] + [0.5, planes, pad, 5, True]
    lanes = sweep_cuda.sweep_lanes(*args)
    for ran, slots in lanes.values():
        assert 0 < ran <= slots and slots % 32 == 0
    lanes_t = torch.zeros(4, dtype=torch.int64, device=dev)
    got = sweep_cuda._launch(tuple(args), lanes_t)
    for g, w in zip(got, sweep_cuda.disparity_sweep(*args)):
        assert torch.equal(g, w)


def homography_rows(rng, hs, ho, w):
    """Row coordinates of a rectifying homography's vertical pass: a mild
    rotation, scale and perspective, smooth in x and y."""
    yo = np.arange(ho, dtype=np.float64)[:, None]
    x = np.arange(w, dtype=np.float64)[None, :]
    a, b, g = rng.uniform(0.9, 1.1), rng.uniform(-0.05, 0.05), rng.uniform(-2e-5, 2e-5)
    q = (a * (hs / ho) * yo + b * x + rng.uniform(-20, 20)) / (1.0 + g * x + g * yo)
    return q.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("coords", ["random", "homography"])
@pytest.mark.parametrize("c,hs,w,ho,wo", [(5, 480, 640, 512, 768), (1, 480, 640, 512, 1024),
                                          (3, 512, 768, 480, 640),
                                          # 752x480 (rect 512x896): a partial last
                                          # column block of 32
                                          (5, 480, 752, 512, 896), (1, 480, 752, 512, 1152),
                                          (3, 512, 896, 480, 752),
                                          # 1920x1080 (rect 1152x2048, pad 384)
                                          (5, 1080, 1920, 1152, 2048),
                                          (1, 1080, 1920, 1152, 2816),
                                          (3, 1152, 2048, 1080, 1920)])
def test_resample_kernels_match_plain(dev, c, hs, w, ho, wo, coords):
    """Both passes equal their plain versions bit for bit at the three
    main-path shapes (ref stack, current frame, back-warp), with row
    coordinates drawn at random or from a homography."""
    rng = np.random.default_rng(c)
    img = torch.tensor(rng.random((c, hs, w), dtype=np.float32), device=dev)
    q = (rng.uniform(-3, hs + 3, (ho, w)).astype(np.float32) if coords == "random"
         else homography_rows(rng, hs, ho, w))
    q = torch.tensor(q, device=dev)
    before = kernels.LAUNCHES["resample_rows"]
    mid = resample_cuda.resample_rows(img, q)
    assert kernels.LAUNCHES["resample_rows"] == before + 1
    assert torch.equal(mid, resample_cuda.resample_rows_plain(img, q))
    u = torch.tensor(rng.uniform(-3, w + 3, (ho, wo)).astype(np.float32), device=dev)
    out = resample_cuda.resample_cols(mid, u)
    assert torch.equal(out, resample_cuda.resample_cols_plain(mid, u))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,iters", [(150, 256, 37), (480, 640, 200), (720, 1280, 20),
                                        (1080, 1920, 200), (1080, 1920, 37)])
def test_tvl1_kernel_matches_plain(dev, h, w, iters):
    """Bit for bit, also where the last launch runs fewer iterations than
    the others (37)."""
    rng = np.random.default_rng(h)
    noisy, a, b, sig = (torch.tensor(rng.uniform(lo, hi, (h, w)).astype(np.float32), device=dev)
                        for lo, hi in ((1.0, 2.0), (5, 20), (5, 20), (0.001, 0.05)))
    cfg = RemodeConfig()
    g = denoise.compute_weights(a, b, sig, 1.7 * 1.7 * cfg.large_sigma_sq_factor)
    before = kernels.LAUNCHES["tvl1"]
    got = denoise_cuda.tvl1(noisy, g, 0.5, iters, cfg)
    assert before < kernels.LAUNCHES["tvl1"] <= before + iters
    assert torch.equal(got, denoise_cuda.tvl1_plain(noisy, g, 0.5, iters, cfg))


@pytest.mark.cuda
def test_wrappers_reject_bad_tensors(dev):
    img = torch.zeros((1, 8, 8), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        resample_cuda.resample_rows(img, torch.zeros((8, 8), device=dev))


@pytest.mark.parametrize("kernel", ["sweep", "resample_rows", "resample_cols", "tvl1"])
def test_wrappers_run_plain_version_on_cpu_tensors(kernel):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing; the lane measurement refuses them."""
    rng = np.random.default_rng(3)
    if kernel == "sweep":
        args = [torch.tensor(a) for a in sweep_cases.edge_cases(5, w=64, pad=32, planes=31)]
        args += [0.5, 31, 32, 5, True]
        calls = (sweep_cuda.disparity_sweep, sweep_cuda.disparity_sweep_plain)
        with pytest.raises(ValueError):
            sweep_cuda.sweep_lanes(*args)
    elif kernel == "tvl1":
        noisy = torch.tensor(rng.uniform(1.0, 2.0, (24, 32)).astype(np.float32))
        args = [noisy, torch.full_like(noisy, 0.7), 0.5, 13, RemodeConfig()]
        calls = (denoise_cuda.tvl1, denoise_cuda.tvl1_plain)
    else:
        img = torch.tensor(rng.random((2, 20, 24), dtype=np.float32))
        coord = torch.tensor(rng.uniform(-2, 26, (20, 30)).astype(np.float32))
        args = [img, coord[:18, :24] if kernel == "resample_rows" else coord]
        calls = (getattr(resample_cuda, kernel), getattr(resample_cuda, kernel + "_plain"))
    before = dict(kernels.LAUNCHES)
    got, want = (fn(*args) for fn in calls)
    for g, w in zip(*((x,) if torch.is_tensor(x) else x for x in (got, want))):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES == before


def test_ctypes_signatures_match_sources():
    """The argtypes declared for ctypes follow the C prototypes in csrc/
    (a mismatch only shows on the card, as a wrong or refused argument)."""
    import ctypes
    import re

    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    protos = {}
    for name in kernels.SOURCES:
        src = (kernels.CSRC / name).read_text()
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            args = [p.strip() for p in params.split(",")]
            protos[fn] = [kinds["ptr"] if "*" in a else kinds[a.split()[0]] for a in args]
    assert "remode_seed_update" in protos
    assert protos == kernels._SIGNATURES
