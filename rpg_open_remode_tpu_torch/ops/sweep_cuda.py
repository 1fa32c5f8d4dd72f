"""The rectified integer-disparity ZNCC sweep: CUDA kernel (``csrc/sweep.cu``)
and its plain PyTorch version.

Counterpart of ``rpg_open_remode_tpu/ops/sweep_pallas.py`` (Pallas
``_sweep_kernel``); the plain version is a port of
``rpg_open_remode_tpu/ops/rect_match._sweep_xla``. For every rect pixel and
integer disparity k < num_planes: ZNCC of the reference patch against the
current patch k columns to the left (zero-padded box sums), masked by ref
validity, the textureless guards, the footprint x-interval ``xlim`` and the
per-pixel band [dlo - 0.5, dhi + 0.5]; a running best with a strict ``>``;
3-point parabolic refinement. Returns ``(disp, ncc, found)``.

``gate`` (a 0-d bool tensor on the inputs' device, or None for on) is the
coarse pass's ``lax.cond`` of the JAX package: the kernel reads it on the
device, and when it is off every pixel comes back not found (disp -10,
ncc -1, found False), as if no band admitted a plane. No host reads it.

The block plane intervals of the Pallas wrapper are TPU scheduling: the
kernel spreads each tile's admitted (pixel, plane) pairs over its threads
instead. ``sweep_lanes`` runs the kernel's counting build, which measures
how many of the lanes its loops run are in use.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.utils.interp import window_sum

_FLT_MIN = 1.1754944e-38
_NEG = -1e30


def box_zero(x: torch.Tensor, side: int) -> torch.Tensor:
    """'same' separable ``side x side`` box sum reading zeros outside the
    grid (the rect-grid convention; cf. utils/interp.box_sum, which clamps)."""
    hp = side // 2
    p = F.pad(x, (hp, hp, hp, hp))
    return window_sum(window_sum(p, side, -1), side, -2)


def _not_found(ref_img):
    shape, dev = ref_img.shape, ref_img.device
    return (torch.full(shape, -10.0, device=dev), torch.full(shape, -1.0, device=dev),
            torch.zeros(shape, dtype=torch.bool, device=dev))


def disparity_sweep_plain(
    curr_pad, xlim, ref_img, valid, disp_lo, disp_hi,
    ncc_threshold: float, num_planes: int, pad: int, patch_side: int,
    subplane_refine: bool, gate=None,
):
    """The sweep with one whole-image tensor op per step (port of
    rect_match._sweep_xla). A gate that is off gives the not-found result
    (on the CPU the gate is read; elsewhere the result is selected)."""
    if gate is not None and not gate.is_cuda and not bool(gate):
        return _not_found(ref_img)
    out = _sweep_plain(curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, ncc_threshold,
                       num_planes, pad, patch_side, subplane_refine)
    if gate is None or not gate.is_cuda:
        return out
    return tuple(torch.where(gate, a, b) for a, b in zip(out, _not_found(ref_img)))


def _sweep_plain(curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, ncc_threshold,
                 num_planes, pad, patch_side, subplane_refine):
    rect_h, rect_w = ref_img.shape
    side = patch_side
    area = float(side * side)
    assert num_planes <= pad - 1, (num_planes, pad)

    sum_t = box_zero(ref_img, side)
    denom_t = area * box_zero(ref_img * ref_img, side) - sum_t * sum_t
    ref_ok = box_zero((valid > 0.999).float(), side) > (area - 0.5)
    ref_ok &= denom_t > 1e-10
    lo = disp_lo - 0.5
    hi = disp_hi + 0.5
    xcoord = torch.arange(rect_w, dtype=torch.float32, device=ref_img.device)[None, :]
    xmin_e = xlim[:, 0:1]
    xmax_e = xlim[:, 1:2]

    best = torch.full_like(ref_img, -1.0)
    best_k = torch.full(ref_img.shape, -10, dtype=torch.int32, device=ref_img.device)
    left = torch.full_like(ref_img, _NEG)
    right = torch.full_like(ref_img, _NEG)
    prev = torch.full_like(ref_img, _NEG)
    neg = torch.full_like(ref_img, _NEG)
    for k in range(num_planes):
        delta = float(k)
        img = curr_pad[:, pad - k: pad - k + rect_w]
        s_i = box_zero(img, side)
        s_ii = box_zero(img * img, side)
        s_it = box_zero(img * ref_img, side)
        num = area * s_it - s_i * sum_t
        den_l = area * s_ii - s_i * s_i
        ncc = num * torch.rsqrt(torch.clamp(den_l * denom_t, min=_FLT_MIN))
        x_src = xcoord - delta
        ok = (
            ref_ok
            & (den_l > 1e-10)
            & (x_src >= xmin_e)
            & (x_src <= xmax_e)
            & (delta >= lo)
            & (delta <= hi)
        )
        ncc = torch.where(ok, ncc, neg)
        improved = ncc > best
        right = torch.where(best_k == k - 1, ncc, right)
        left = torch.where(improved, prev, left)
        right = torch.where(improved, neg, right)
        best_k = torch.where(improved, k, best_k)
        best = torch.where(improved, ncc, best)
        prev = ncc

    kf = best_k.float()
    if subplane_refine:
        have = (left > 0.5 * _NEG) & (right > 0.5 * _NEG)
        den = left - 2.0 * best + right
        frac = torch.where(
            have & (torch.abs(den) > 1e-12), 0.5 * (left - right) / den,
            torch.zeros_like(den),
        )
        kf = kf + torch.clamp(frac, -0.5, 0.5)
    found = (best >= ncc_threshold) & (best_k >= 0)
    return kf, best, found


def _launch(args, lanes=None, gate=None):
    """Validate the inputs and launch the kernel (its counting build, adding
    into the int64 tensor ``lanes``, when one is given)."""
    (curr_pad, xlim, ref_img, valid, disp_lo, disp_hi,
     ncc_threshold, num_planes, pad, patch_side, subplane_refine) = args
    h, w = ref_img.shape
    if num_planes > pad - 1:
        raise ValueError(f"num_planes {num_planes} needs disp_pad > {num_planes}")
    if patch_side % 2 != 1 or patch_side > 17:
        raise ValueError(f"patch_side must be odd and <= 17, got {patch_side}")
    kernels.require(curr_pad, "curr_pad", (h, w + 2 * pad))
    kernels.require(xlim, "xlim", (h, 2))
    for name, t in (("ref_img", ref_img), ("valid", valid),
                    ("disp_lo", disp_lo), ("disp_hi", disp_hi)):
        kernels.require(t, name, (h, w))
    if gate is not None:
        kernels.require(gate, "gate", (), torch.bool)
    dev = ref_img.device
    disp = torch.empty((h, w), dtype=torch.float32, device=dev)
    ncc = torch.empty((h, w), dtype=torch.float32, device=dev)
    found = torch.empty((h, w), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (curr_pad, xlim, ref_img, valid, disp_lo, disp_hi,
                                   disp, ncc, found)]
    scalars = [h, w, pad, num_planes, patch_side, float(ncc_threshold),
               int(bool(subplane_refine)), None if gate is None else gate.data_ptr()]
    lib = kernels.library()
    if lanes is None:
        err = lib.remode_sweep(*ptrs, *scalars, kernels.stream_of(ref_img))
    else:
        kernels.require(lanes, "lanes", (4,), torch.int64)
        err = lib.remode_sweep_lanes(*ptrs, *scalars, lanes.data_ptr(),
                                     kernels.stream_of(ref_img))
    kernels.check(err, "sweep")
    kernels.count("sweep")
    return disp, ncc, found


def disparity_sweep(
    curr_pad, xlim, ref_img, valid, disp_lo, disp_hi,
    ncc_threshold: float, num_planes: int, pad: int, patch_side: int,
    subplane_refine: bool, gate=None,
):
    """Run the sweep: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. ``curr_pad`` [H, W + 2 pad], ``xlim`` [H, 2], the rest
    [H, W], ``gate`` None or a 0-d bool. Returns ``(disp, ncc, found)`` on
    the rect grid."""
    args = (curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, ncc_threshold,
            num_planes, pad, patch_side, subplane_refine)
    if not ref_img.is_cuda:
        return disparity_sweep_plain(*args, gate=gate)
    return _launch(args, gate=gate)


def sweep_lanes(*args) -> dict:
    """Lane use of the kernel's loops on these inputs (the arguments of
    ``disparity_sweep``, on the card): the counting build adds, for every
    warp-step, the lanes that ran it (``__activemask``) and the warp's 32.
    Returns ``{"scoring": (lanes, slots), "per_pixel": (lanes, slots)}``: the
    loop that scores the tile's pairs, and the loops over each pixel's own
    pairs (owner map and scan)."""
    if not args[2].is_cuda:
        raise ValueError("sweep_lanes measures the CUDA kernel: pass CUDA tensors")
    lanes = torch.zeros(4, dtype=torch.int64, device=args[2].device)
    _launch(args, lanes)
    c = [int(v) for v in lanes.cpu()]
    return {"scoring": (c[0], c[1]), "per_pixel": (c[2], c[3])}


def sweep_occupancy(patch_side: int, num_planes: int) -> dict:
    """The kernel's launch figures at this patch and plane count, from the
    card: the dynamic shared memory of one block (bytes; past 48 KB the
    kernel opts in to more) and the blocks one SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    nbytes, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = kernels.library().remode_sweep_occupancy(
        patch_side, num_planes, ctypes.byref(nbytes), ctypes.byref(blocks))
    kernels.check(err, "sweep occupancy")
    return {"smem_bytes": nbytes.value, "blocks_per_sm": blocks.value}
