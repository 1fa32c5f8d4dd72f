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

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("patch_side,refine", [(5, True), (9, True), (5, False)])
def test_sweep_kernel_matches_plain(dev, patch_side, refine):
    rng = np.random.default_rng(7)
    h, w, pad, planes = 128, 512, 128, 127
    ref = rng.random((h, w), dtype=np.float32)
    curr = rng.random((h, w + 2 * pad), dtype=np.float32)
    curr[:, pad - 20: pad - 20 + w] = 0.5 * curr[:, pad - 20: pad - 20 + w] + 0.5 * ref
    valid = np.ones((h, w), np.float32)
    valid[:, :7] = 0.0
    xlim = np.tile(np.array([[-50.0, w + 50.0]], np.float32), (h, 1))
    lo = rng.uniform(0, 60, (h, w)).astype(np.float32)
    hi = lo + rng.uniform(0, 70, (h, w)).astype(np.float32)
    lo[:10], hi[:10] = np.inf, -np.inf
    args = [torch.tensor(a, device=dev) for a in (curr, xlim, ref, valid, lo, hi)]
    before = kernels.LAUNCHES["sweep"]
    got = sweep_cuda.disparity_sweep(*args, 0.5, planes, pad, patch_side, refine)
    assert kernels.LAUNCHES["sweep"] == before + 1
    want = sweep_cuda.disparity_sweep_plain(*args, 0.5, planes, pad, patch_side, refine)
    fk, fp = got[2].cpu().numpy(), want[2].cpu().numpy()
    assert (fk == fp).mean() >= 0.999
    both = fk & fp
    assert both.sum() > 100
    np.testing.assert_allclose(got[0].cpu().numpy()[both], want[0].cpu().numpy()[both], atol=1e-3)
    np.testing.assert_allclose(got[1].cpu().numpy()[both], want[1].cpu().numpy()[both], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hs,w,ho,wo", [(5, 480, 640, 512, 768), (1, 480, 640, 512, 1024),
                                          (3, 512, 768, 480, 640)])
def test_resample_kernels_match_plain(dev, c, hs, w, ho, wo):
    rng = np.random.default_rng(c)
    img = torch.tensor(rng.random((c, hs, w), dtype=np.float32), device=dev)
    q = torch.tensor(rng.uniform(-3, hs + 3, (ho, w)).astype(np.float32), device=dev)
    mid = resample_cuda.resample_rows(img, q)
    torch.testing.assert_close(mid, resample_cuda.resample_rows_plain(img, q), atol=1e-5, rtol=0)
    u = torch.tensor(rng.uniform(-3, w + 3, (ho, wo)).astype(np.float32), device=dev)
    out = resample_cuda.resample_cols(mid, u)
    torch.testing.assert_close(out, resample_cuda.resample_cols_plain(mid, u), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,iters", [(150, 256, 37), (480, 640, 200), (720, 1280, 20)])
def test_tvl1_kernel_matches_plain(dev, h, w, iters):
    rng = np.random.default_rng(h)
    noisy, a, b, sig = (torch.tensor(rng.uniform(lo, hi, (h, w)).astype(np.float32), device=dev)
                        for lo, hi in ((1.0, 2.0), (5, 20), (5, 20), (0.001, 0.05)))
    cfg = RemodeConfig()
    g = denoise.compute_weights(a, b, sig, 1.7 * 1.7 * cfg.large_sigma_sq_factor)
    before = kernels.LAUNCHES["tvl1"]
    got = denoise_cuda.tvl1(noisy, g, 0.5, iters, cfg)
    assert kernels.LAUNCHES["tvl1"] == before + iters
    want = denoise_cuda.tvl1_plain(noisy, g, 0.5, iters, cfg)
    torch.testing.assert_close(got, want, atol=1e-5 * float(noisy.max() - noisy.min()), rtol=0)


@pytest.mark.cuda
def test_wrappers_reject_bad_tensors(dev):
    img = torch.zeros((1, 8, 8), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        resample_cuda.resample_rows(img, torch.zeros((8, 8), device=dev))


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
    assert protos == kernels._SIGNATURES
