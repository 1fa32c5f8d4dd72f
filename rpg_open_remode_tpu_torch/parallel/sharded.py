"""The engine's step, denoise and reseed on a mesh (counterpart of
``rpg_open_remode_tpu/parallel/sharded.py``).

Layout, as the JAX package shards it:
  - seed state in tiles: each rank holds the ``[H/ty, W/tx]`` tiles of its
    kf row's ``n_keyframes / kf`` local slots, a list of frozen
    ``SeedState``s (the slots of ``models/multikeyframe``);
  - the current frame on every rank (each rank is fed the same frame);
  - the per-keyframe counts summed over the tiles, and one ``[KF, 6]``
    metrics matrix (``SHARDED_PACKED_KEYS``) equal on every rank, so the
    lifecycle policy decides alike everywhere;
  - halo exchange only where stencils cross tiles: the plane sweep's
    patch-radius halo, and a 1-px halo per TV-L1 iteration.

The JAX ``lax.scan`` over the local keyframes is a loop over the local
slots, in the same order on every rank. Both matcher branches run
collectives, so every rank must take the same one: a degenerate keyframe
anywhere sends every keyframe of that local index through the tile plane
sweep for the frame (the JAX ``lax.pmax`` over ``kf``, then ``lax.cond``).
The sharded step sends near-zero baseline there too, where the
single-device matcher takes the pure-rotation branch
(``ops/rect_match.match``). The regime is chosen on the host
(``sharded_regime``) from host copies of every global slot's keyframe pose
and mean depth, which every rank holds alike, so no collective decides it
and every rank runs the same exchanges; the step takes it as an argument.
``_degenerate`` is the device's form of the same test, the JAX package's;
the tests and ``chip_smoke.py`` hold the host choice against it and the
``kf`` max.

These functions run eagerly. ``parallel/programs.py`` captures them as the
mesh's compiled programs (the JAX ``jax.jit`` of each ``shard_map``), with
each collective an exchange point between graph segments.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.depthmap import prep_image
from rpg_open_remode_tpu_torch.models.state import SceneParams, SeedState, states_from_numpy
from rpg_open_remode_tpu_torch.ops import denoise as denoise_ops
from rpg_open_remode_tpu_torch.ops import (
    epipolar, propagate, rect_match, seed_check, seed_update_cuda,
)
from rpg_open_remode_tpu_torch.ops.seed_init import template_stats
from rpg_open_remode_tpu_torch.parallel import collectives
from rpg_open_remode_tpu_torch.parallel.halo import exchange_halo_2d
from rpg_open_remode_tpu_torch.parallel.mesh import coords_of
from rpg_open_remode_tpu_torch.parallel.rect_sharded import _gather_full, match_rectified_sharded
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

# order of the per-keyframe metrics in the sharded step's stats["packed"]
# (the sharded step has no mean_ncc: the matcher's fields stay tile-local)
SHARDED_PACKED_KEYS = (
    "update", "converged", "border", "diverged", "no_match", "dist_from_ref",
)


# -- carrying a batched state across, tile by tile ---------------------------


def split_state_numpy(arrays: dict, shape, rank: int) -> dict:
    """Rank ``rank``'s part of a batched numpy state (the JAX layout, as
    ``models.state.states_from_numpy`` takes it: every leaf with a leading
    ``[KF]`` axis): its kf row's local slots, image fields cut to its tile."""
    kf, ty, tx = shape
    k, y, x = coords_of(shape, rank)
    n_local = len(arrays["mu"]) // kf
    slots = slice(k * n_local, (k + 1) * n_local)
    height, width = arrays["mu"].shape[-2:]
    th, tw = height // ty, width // tx
    ys, xs = slice(y * th, (y + 1) * th), slice(x * tw, (x + 1) * tw)
    out = {}
    for name, v in arrays.items():
        if name == "scene":
            out[name] = {f: np.asarray(a)[slots] for f, a in v.items()}
        elif name == "T_world_ref":
            out[name] = np.asarray(v)[slots]
        else:
            out[name] = np.ascontiguousarray(np.asarray(v)[slots][..., ys, xs])
    return out


def join_state_numpy(parts: list, shape) -> dict:
    """Inverse of ``split_state_numpy`` over every rank's part (in rank
    order): the batched numpy state."""
    kf, ty, tx = shape
    per_row = ty * tx
    out = {}
    for name, v in parts[0].items():
        if name == "scene":
            out[name] = {f: np.concatenate([parts[k * per_row][name][f] for k in range(kf)])
                         for f in v}
        elif name == "T_world_ref":
            out[name] = np.concatenate([parts[k * per_row][name] for k in range(kf)])
        else:
            rows = [np.concatenate([
                np.concatenate([parts[(k * ty + y) * tx + x][name] for x in range(tx)], axis=-1)
                for y in range(ty)], axis=-2) for k in range(kf)]
            out[name] = np.concatenate(rows)
    return out


def shard_state(arrays: dict, mesh) -> list[SeedState]:
    """This rank's local slots, as tiles on its device, from a batched numpy
    state."""
    return states_from_numpy(split_state_numpy(arrays, mesh.shape, mesh.rank),
                             device=mesh.device)


def tile_state(state: SeedState, mesh) -> SeedState:
    """This rank's tile of a full-grid state."""
    y0, x0, th, tw = mesh.tile(*state.shape)

    def cut(x):
        return x[..., y0:y0 + th, x0:x0 + tw].contiguous()

    return dataclasses.replace(state, **{
        f.name: cut(getattr(state, f.name)) for f in dataclasses.fields(SeedState)
        if f.name not in ("T_world_ref", "scene")})


# -- the step ----------------------------------------------------------------


def _degenerate(T_curr_ref, scene, cam, cfg: RemodeConfig, height: int, width: int):
    """The regimes rectification cannot serve, as ``ops/rect_match.match``
    tests them: near-zero baseline, and (with ``forward_motion_fallback``)
    an epipole inside or near either footprint. A 0-d int32 tensor: the
    JAX step's own test on the device, the oracle ``sharded_regime`` is
    held against (with an ``all_reduce`` max over ``kf``)."""
    R = se3.rotation(T_curr_ref)
    t = se3.translation(T_curr_ref)
    C = -R.T @ t
    degenerate = torch.linalg.norm(C) <= 1e-5 * scene.avg_depth + 1e-9
    if cfg.forward_motion_fallback:
        m_x, m_y = 0.75 * width, 0.75 * height

        def _inside(e):
            return ((torch.abs(cam.fx * e[0]) < m_x * torch.abs(e[2]))
                    & (torch.abs(cam.fy * e[1]) < m_y * torch.abs(e[2])))

        degenerate = degenerate | _inside(C) | _inside(t)
    return degenerate.to(torch.int32)


def sharded_regime(T_curr_world, slots, cam, cfg: RemodeConfig, height: int, width: int,
                   kf: int = 1):
    """The sharded step's regime from host copies: for each local slot
    index, whether the tile plane sweep runs (True) or the rectified bands
    (False); None where the config has no choice (``match_mode`` other than
    "rect", or no ``zero_baseline_fallback``). ``slots`` holds
    ``(T_world_ref [3, 4], avg_depth)`` of every global slot in slot order,
    ``cam`` is ``(fx, fy)``, ``kf`` the kf axis size. ``_degenerate`` of each
    slot, in numpy float32 in the device's order of operations
    (``ops/rect_match.regime_index``, whose two degenerate branches are
    its predicate), then the max over the kf rows that share a local
    index: the ``kf`` max of the device path without a collective."""
    if not (cfg.match_mode == "rect" and cfg.zero_baseline_fallback):
        return None
    fx, fy = cam
    deg = [rect_match.regime_index(T_curr_world, T_ref, avg, fx, fy, height, width, cfg)
           != rect_match.RECTIFIED for T_ref, avg in slots]
    n_local = len(deg) // kf
    return tuple(any(deg[k * n_local + i] for k in range(kf)) for i in range(n_local))


def build_sharded_update(mesh, cam: PinholeCamera, cfg: RemodeConfig, height: int, width: int):
    """``step(states, curr_img, T_curr_world, regime) -> (states', stats)``:
    one engine step of this rank's local slots (``states``, tiles), every
    rank calling it with the same frame, already on the rank's device
    (``[H, W]`` uint8 or float, ``[3, 4]`` float32). ``regime`` is
    ``sharded_regime``'s choice (None where the config has none to make).
    ``stats`` holds each key of ``SHARDED_PACKED_KEYS`` for the local slots
    (counts over the whole keyframe) and ``packed``, the ``[KF, 6]`` matrix
    of every slot, equal on every rank."""
    y0, x0, th, tw = mesh.tile(height, width)
    p = cfg.patch_side // 2
    dev = mesh.device
    m = cfg.patch_side
    ys_g = y0 + torch.arange(th, device=dev)[:, None]
    xs_g = x0 + torch.arange(tw, device=dev)[None, :]
    border = ~((xs_g >= m) & (xs_g <= width - m - 1) & (ys_g >= m) & (ys_g <= height - m - 1))
    ys_ext = torch.clamp(torch.arange(-p, th + p, device=dev) + y0, 0, height - 1)
    xs_ext = torch.clamp(torch.arange(-p, tw + p, device=dev) + x0, 0, width - 1)
    f_ext = epipolar.bearings_for_grid(cam, ys_ext, xs_ext)
    spatial_leader = mesh.axis_index("sp") == 0

    def sweep_fn(st, curr_img, T_curr_ref):
        ref_ext = exchange_halo_2d(st.ref_img, p, mesh)
        return epipolar.match_planesweep_tile(
            ref_ext, f_ext, st.mu, st.sigma_sq, st.sum_templ, st.const_templ_denom,
            st.scene, curr_img, T_curr_ref, cam, cfg)

    def rect_fn(st, curr_img, T_curr_ref):
        return match_rectified_sharded(st, curr_img, T_curr_ref, cam, cfg, height, width,
                                       (y0, x0), mesh)

    def per_kf(st: SeedState, curr_img, T_curr_world, degenerate):
        T_curr_ref = se3.compose(T_curr_world, st.T_world_ref)
        conv1 = seed_check.classify_seeds(st.mu, st.sigma_sq, st.a, st.b, st.scene.epsilon,
                                          border, cfg)
        st = dataclasses.replace(st, conv=conv1)
        if choice:
            fn = sweep_fn if degenerate else rect_fn
        else:
            fn = rect_fn if cfg.match_mode == "rect" else sweep_fn
        res = fn(st, curr_img, T_curr_ref)
        new_st, counts, _ = seed_update_cuda.fused_seed_update(st, res, se3.inv(T_curr_ref),
                                                               cam, cfg)
        return new_st, counts.float(), torch.linalg.norm(se3.translation(T_curr_ref))

    choice = cfg.match_mode == "rect" and cfg.zero_baseline_fallback

    def step(states, curr_img, T_curr_world, regime):
        if (regime is None) == choice:
            raise ValueError(f"regime {regime} for a config that "
                             f"{'has' if choice else 'has no'} choice to make")
        curr_img = prep_image(curr_img)
        regime = regime or (None,) * len(states)
        out = [per_kf(st, curr_img, T_curr_world, deg) for st, deg in zip(states, regime)]
        n_local = len(states)
        first = mesh.axis_index("kf") * n_local
        # one [KF, 6] matrix summed over every rank: each tile adds its
        # counts, the spatial leader its slots' distance
        full = torch.zeros((n_local * mesh.axis_size("kf"), 6), dtype=torch.float32, device=dev)
        full[first:first + n_local, :5] = torch.stack([o[1] for o in out])
        if spatial_leader:
            full[first:first + n_local, 5] = torch.stack([o[2] for o in out])
        full = collectives.all_reduce(mesh, full, "world", "sum")
        local = full[first:first + n_local]
        stats = {k: local[:, j].to(torch.int32) for j, k in enumerate(SHARDED_PACKED_KEYS[:5])}
        stats["dist_from_ref"] = local[:, 5]
        stats["packed"] = full
        return [o[0] for o in out], stats

    return step


# -- denoise -----------------------------------------------------------------


def build_sharded_denoise(mesh, cfg: RemodeConfig, height: int, width: int,
                          iterations: int = 200):
    """``run(states, lam, slots=None) -> [tile]``: TV-L1 of the local slots
    (indices ``slots``, default all) on their tiles, with a 1-px halo
    exchange of ``u_head``, ``p_x`` and ``p_y`` every iteration (the JAX
    ``fori_loop``, in plain PyTorch); every rank of the kf row calls it
    alike."""
    y0, x0, th, tw = mesh.tile(height, width)
    dev = mesh.device
    col_g = x0 + torch.arange(tw, device=dev)[None, :]
    row_g = y0 + torch.arange(th, device=dev)[:, None]
    sigma_d, tau, theta = cfg.tv_sigma, cfg.tv_tau, cfg.tv_theta

    def one(st: SeedState, thr: float):
        large = st.scene.depth_range ** 2 * cfg.large_sigma_sq_factor
        g = denoise_ops.compute_weights(st.a, st.b, st.sigma_sq, large)
        noisy = st.mu
        u, u_head = noisy, noisy
        p_x, p_y = torch.zeros_like(noisy), torch.zeros_like(noisy)
        zero = torch.zeros_like(noisy)
        for _ in range(iterations):
            uh = exchange_halo_2d(u_head, 1, mesh)
            grad_x = uh[1:-1, 2:] - u
            grad_y = uh[2:, 1:-1] - u
            tp_x = g * grad_x * sigma_d + p_x
            tp_y = g * grad_y * sigma_d + p_y
            mag = torch.sqrt(tp_x * tp_x + tp_y * tp_y)
            scale = 1.0 / torch.clamp(mag, min=1.0)
            p_x = tp_x * scale
            p_y = tp_y * scale
            pxe = exchange_halo_2d(p_x, 1, mesh)
            pye = exchange_halo_2d(p_y, 1, mesh)
            cur_px = torch.where(col_g >= width - 1, zero, p_x)
            cur_py = torch.where(row_g >= height - 1, zero, p_y)
            w_px = torch.where(col_g == 0, zero, pxe[1:-1, :-2])
            n_py = torch.where(row_g == 0, zero, pye[:-2, 1:-1])
            div = cur_px - w_px + cur_py - n_py
            temp_u = u + tau * g * div
            diff = temp_u - noisy
            u_new = torch.where(diff > thr, temp_u - thr,
                                torch.where(diff < -thr, temp_u + thr, noisy))
            u_head = u_new + theta * (u_new - u)
            u = u_new
        return u

    def run(states, lam, slots=None):
        thr = denoise_ops.shrink_threshold(lam, cfg)
        chosen = range(len(states)) if slots is None else slots
        return [one(states[i], thr) for i in chosen]

    return run


# -- reseed ------------------------------------------------------------------


def _propagated_priors(st: SeedState, T_world_ref, scene, cam, cfg, flat, tile, mesh):
    """The warm-start priors of a propagating reseed on this rank's tile:
    the slot's old state gathered over the spatial axis, propagated on the
    full grid on every rank of the kf row (``ops/propagate.py``), and this
    tile cut out; pixels the propagation rejects keep ``flat``."""
    full = _gather_full(torch.stack([st.mu, st.sigma_sq, st.a, st.b, st.conv.float()]), mesh)
    old = types.SimpleNamespace(mu=full[0], sigma_sq=full[1], a=full[2], b=full[3],
                                conv=full[4].to(torch.int32), T_world_ref=st.T_world_ref,
                                scene=st.scene)
    mu_p, sig_p, a_p, b_p, valid = propagate.propagate_depth(
        old, se3.inv(T_world_ref), scene, cam, cfg)
    vt = tile(valid)
    return tuple(torch.where(vt, tile(pr), fl) for pr, fl in zip((mu_p, sig_p, a_p, b_p), flat))


def build_sharded_reseed(mesh, cam: PinholeCamera, cfg: RemodeConfig, height: int, width: int):
    """``reseed(states, slot, img, T_world_ref, scene) -> states'``: re-seed
    global slot ``slot`` with a new reference frame (the sharded sibling of
    ``BatchedDepthmap.seed_keyframe``, seedInitKernel seed_init.cu:27-61).
    Every rank calls it alike; the ranks of the kf row that holds the slot
    replace that slot's tile, the others return ``states`` as they are.

    The template box sums are computed on the full image and the tile cut
    out. With ``cfg.propagate_depth`` the slot warm-starts from its own
    outgoing posterior, gathered over the spatial axis of its kf row only.
    A new list is returned; the old states stay valid, so a finalizing
    keyframe's snapshot can be read after the reseed."""
    y0, x0, th, tw = mesh.tile(height, width)
    dev = mesh.device

    def tile(x):
        return x[y0:y0 + th, x0:x0 + tw].contiguous()

    def reseed(states, slot: int, img, T_world_ref, scene: SceneParams):
        local = slot - mesh.axis_index("kf") * len(states)
        if not 0 <= local < len(states):
            return states
        st = states[local]
        img = prep_image(torch.as_tensor(img).to(dev))
        T_world_ref = torch.as_tensor(T_world_ref, dtype=torch.float32).to(dev)
        sum_t, denom = template_stats(img, cfg)
        shape = (th, tw)
        prior = (
            scene.avg_depth.expand(shape).clone(),
            scene.sigma_sq_max.expand(shape).clone(),
            torch.full(shape, cfg.a_init, dtype=torch.float32, device=dev),
            torch.full(shape, cfg.b_init, dtype=torch.float32, device=dev),
        )
        if cfg.propagate_depth:
            prior = _propagated_priors(st, T_world_ref, scene, cam, cfg, prior, tile, mesh)
        mu0, sig0, a0, b0 = prior
        new = SeedState(
            ref_img=tile(img), sum_templ=tile(sum_t), const_templ_denom=tile(denom),
            f_ref=st.f_ref,   # bearings depend only on the camera
            mu=mu0, sigma_sq=sig0, a=a0, b=b0,
            conv=torch.full(shape, int(ConvergenceState.UPDATE), dtype=torch.int32, device=dev),
            match_u=torch.zeros(shape, dtype=torch.float32, device=dev),
            match_v=torch.zeros(shape, dtype=torch.float32, device=dev),
            T_world_ref=T_world_ref, scene=scene,
        )
        return states[:local] + [new] + states[local + 1:]

    return reseed
