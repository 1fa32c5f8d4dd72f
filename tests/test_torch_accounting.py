"""The port's sweep accounting (``ops/accounting.py``): its pair count
against the plain sweep's own masks, its record's consistency on a live
engine (as tests/test_straggler.py holds the JAX record), and the
quantities both packages count alike against the JAX ``sweep_counts``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_open_remode_tpu.config import RemodeConfig as JConfig
from rpg_open_remode_tpu.models.depthmap import Depthmap as JDepthmap
from rpg_open_remode_tpu.ops import accounting as jaccounting
from rpg_open_remode_tpu.utils import synthetic
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.ops import accounting
from rpg_open_remode_tpu_torch.ops.sweep_cuda import box_zero
from rpg_open_remode_tpu_torch.testing import sweep_cases
from torch_parity import jax_state_numpy

torch.set_num_threads(2)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _plain_pairs(curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, planes, patch):
    """The (pixel, plane) pairs that disparity_sweep_plain's masks admit
    before the current patch's texture guard: the pairs the CUDA kernel
    scores."""
    area = float(patch * patch)
    sum_t = box_zero(ref_img, patch)
    denom_t = area * box_zero(ref_img * ref_img, patch) - sum_t * sum_t
    ref_ok = (box_zero((valid > 0.999).float(), patch) > (area - 0.5)) & (denom_t > 1e-10)
    x = torch.arange(ref_img.shape[1], dtype=torch.float32)[None, :]
    n = 0
    for k in range(planes):
        delta = float(k)
        ok = (ref_ok & (x - delta >= xlim[:, 0:1]) & (x - delta <= xlim[:, 1:2])
              & (delta >= disp_lo - 0.5) & (delta <= disp_hi + 0.5))
        n += int(ok.sum())
    return n


def _cases():
    rng = np.random.default_rng(11)
    xlim = np.tile(np.array([[-40.0, 300.5]], np.float32), (64, 1))
    xlim[10:20] = [[30.25, 120.75]]
    xlim[20:24] = [[200.0, 100.0]]          # an empty footprint row
    return {
        "edge cases": (sweep_cases.edge_cases(5), 127, 128, 5),
        "ragged bands": (sweep_cases.ragged_bands(rng, 64, 256, 128, 127), 127, 128, 5),
        "ragged bands, cut footprints": (
            (lambda a: (a[0], xlim, *a[2:]))(sweep_cases.ragged_bands(rng, 64, 256, 64, 63)),
            63, 64, 9),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_call_work_counts_the_plain_sweeps_pairs(case):
    arrays, planes, pad, patch = _cases()[case]
    args = [torch.tensor(a) for a in arrays]
    work = accounting.call_work(*args, 0.5, planes, pad, patch, True)
    want = _plain_pairs(*args, planes, patch)
    assert want > 0
    assert work["pairs"] == want
    assert work["pairs"] <= work["band_pairs"] <= planes * args[2].numel()
    assert work["bytes"] > 0 and work["flops"] > 0
    # the bound's operations: the ZNCC's algorithmic 12 hp + 11 a scored pair
    assert work["flops"] == want * (12.0 * (patch // 2) + 11.0)
    assert work["flops_exec"] > work["flops"]


def _engine(cfg_kw=None):
    w, h = 320, 192
    cam = dict(fx=240.6, fy=-240.0, cx=(w - 1) / 2, cy=(h - 1) / 2)
    return w, h, cam, P.Depthmap(w, h, cfg=P.RemodeConfig(**(cfg_kw or {})), device="cpu", **cam)


def test_frame_accounting_consistent():
    """tests/test_straggler.py's protocol on the port: a mid-life engine
    scores some of its band pairs, never more than the cost volume, at a
    sane share of peak; a young keyframe with a real baseline runs and
    counts the coarse pass."""
    w, h, cam, eng = _engine()
    frames = synthetic.generate(n_frames=8, width=w, height=h, cam=cam, seed=3)
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    eng.set_reference_image(f0.image, _Tcw(f0), d.min(), d.max())
    for fr in frames[1:6]:
        eng.update(fr.image, _Tcw(fr))
    rec = accounting.frame_accounting(eng, frames[6].image, _Tcw(frames[6]), 0.01)
    assert 0 < rec["pairs_swept"] <= rec["band_pairs"] <= rec["pairs_full"]
    assert 0.0 < rec["skip_ratio"] <= 1.0
    assert rec["est_tflops"] > 0 and rec["sweep_gflops_exec"] > rec["sweep_gflops_alg"]
    assert 0 <= rec["mfu_pct"] < 100 and rec["sweep_bound_ms"] > 0

    fast = synthetic.generate(n_frames=4, width=w, height=h, cam=cam, seed=3, step=0.12)
    g0 = fast[0]
    dg = g0.depth[np.isfinite(g0.depth)]
    _, _, _, eng2 = _engine()
    eng2.set_reference_image(g0.image, _Tcw(g0), dg.min(), dg.max())
    eng2.update(fast[1].image, _Tcw(fast[1]))
    rec2 = accounting.frame_accounting(eng2, fast[2].image, _Tcw(fast[2]), 0.01)
    assert rec2["coarse_fired"] and rec2["coarse_pairs"] > 0, rec2


def test_counts_match_jax_where_alike():
    """From one carried-across state and frame: the per-pixel band widths
    (``pixel_ideal_plane_px``, rtol 1e-4: the bands come from float32
    warps) and whether the coarse pass fires equal the JAX record's."""
    w, h, cam, eng = _engine()
    frames = synthetic.generate(n_frames=4, width=w, height=h, cam=cam, seed=3, step=0.12)
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    jeng = JDepthmap(w, h, cfg=JConfig(pallas_interpret=True), **cam)
    jeng.set_reference_image(f0.image, _Tcw(f0), d.min(), d.max())
    jeng.update(frames[1].image, _Tcw(frames[1]))
    eng.restore(P.state_from_numpy(jax_state_numpy(jeng.state), device="cpu"))
    want = jaccounting.frame_accounting(jeng, jnp.asarray(frames[2].image), _Tcw(frames[2]), 0.01)
    got = accounting.frame_accounting(eng, frames[2].image, _Tcw(frames[2]), 0.01)
    assert got["coarse_fired"] == want["coarse_fired"]
    assert got["pixel_ideal_plane_px"] == pytest.approx(want["pixel_ideal_plane_px"], rel=1e-4)
    assert 0 < got["pairs_swept"] <= got["pairs_full"]
