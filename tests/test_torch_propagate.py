"""Keyframe depth propagation in the port against the JAX package, on the
160x120 scene of ``tests/test_seed_ops.py::TestDepthPropagation`` (seed 4,
``num_planes=96``): 24 updates on frames 1-24, a switch to frame 26, then
eight updates on frames 27-34.

(a) The facade: ``Depthmap(propagate_depth=True).set_reference_image``
warm-starts the new keyframe from the outgoing posterior, as the JAX facade
does (it used to re-seed flat whatever the flag said).
(b) ``propagate_depth`` itself on a state carried across from the JAX run.
(c) Eight updates after the propagated switch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rpg_open_remode_tpu as J
from rpg_open_remode_tpu.models.state import SceneParams as JScene
from rpg_open_remode_tpu.ops import propagate as jprop
from rpg_open_remode_tpu.utils import synthetic
from rpg_open_remode_tpu.utils.camera import PinholeCamera as JCam
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.models.state import SceneParams as PScene
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera as PCam
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
SWITCH = 26


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _engine(pkg, **kw):
    cfg = pkg.RemodeConfig(num_planes=96, propagate_depth=True)
    return pkg.Depthmap(160, 120, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=cfg, **kw)


def _bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


@pytest.fixture(scope="module")
def frames():
    return synthetic.generate(n_frames=36, width=160, height=120, cam=CAM, seed=4)


@pytest.fixture(scope="module")
def jax_run(frames):
    """The JAX engine's state before the switch, after it, and after eight
    more updates."""
    eng = _engine(J)
    eng.set_reference_image(frames[0].image, _Tcw(frames[0]), *_bounds(frames[0]))
    for fr in frames[1:25]:
        eng.update(fr.image, _Tcw(fr))
    out = dict(pre=jax_state_numpy(eng.state), pre_state=eng.state)
    new = frames[SWITCH]
    eng.set_reference_image(new.image, _Tcw(new), *_bounds(new))
    out["post"] = jax_state_numpy(eng.state)
    for fr in frames[SWITCH + 1:SWITCH + 9]:
        eng.update(fr.image, _Tcw(fr))
    out["after"] = jax_state_numpy(eng.state)
    return out


def _carried(state):
    """Pixels that took the propagated prior (their variance is no longer
    the flat sigma_sq_max)."""
    return state["sigma_sq"] != state["scene"]["sigma_sq_max"]


def _rel(got, want):
    return np.abs(got - want) / np.abs(want)


def _check_reseed(got, want):
    """valid agreement >= 0.999, a/b exact, and the fraction of common
    carried pixels whose mu and sigma_sq are within rtol 1e-4."""
    v_got, v_want = _carried(got), _carried(want)
    assert v_want.mean() > 0.15, v_want.mean()
    assert np.mean(v_got == v_want) >= 0.999
    np.testing.assert_array_equal(got["a"], want["a"])
    np.testing.assert_array_equal(got["b"], want["b"])
    both = v_got & v_want
    return {k: float(np.mean(_rel(got[k], want[k])[both] <= 1e-4)) for k in ("mu", "sigma_sq")}


def test_facade_propagates_from_carried_state(frames, jax_run):
    """(a) From the JAX engine's pre-switch state, the port facade's switch
    gives the JAX facade's reseed: every common carried pixel within rtol
    1e-4. A port that ignores the flag carries no pixel and fails."""
    eng = _engine(P, device="cpu")
    eng.restore(P.state_from_numpy(jax_run["pre"], device="cpu"))
    new = frames[SWITCH]
    eng.set_reference_image(new.image, _Tcw(new), *_bounds(new))
    within = _check_reseed(P.state_to_numpy(eng.state), jax_run["post"])
    assert within == {"mu": 1.0, "sigma_sq": 1.0}, within


def test_facade_propagates_after_own_updates(frames, jax_run):
    """(a) The port engine's own 24 updates, then the switch. The two
    pre-switch posteriors differ by float32 rounding (a converging seed's
    sigma_sq by ~1e-3 of itself, tests/test_torch_depthmap.py), which the
    warp carries over: mu stays within rtol 1e-4 on >= 0.99 of the common
    carried pixels; the carried sigma_sq within rtol 1e-2 on >= 0.99."""
    eng = _engine(P, device="cpu")
    eng.set_reference_image(frames[0].image, _Tcw(frames[0]), *_bounds(frames[0]))
    for fr in frames[1:25]:
        eng.update(fr.image, _Tcw(fr))
    new = frames[SWITCH]
    eng.set_reference_image(new.image, _Tcw(new), *_bounds(new))
    got, want = P.state_to_numpy(eng.state), jax_run["post"]
    within = _check_reseed(got, want)
    assert within["mu"] >= 0.99, within
    both = _carried(got) & _carried(want)
    assert np.mean(_rel(got["sigma_sq"], want["sigma_sq"])[both] <= 1e-2) >= 0.99


def test_propagate_depth_on_carried_state(frames, jax_run):
    """(b) The function on the same carried-across state and pose."""
    from rpg_open_remode_tpu_torch.ops import propagate as pprop

    new = frames[SWITCH]
    dmin, dmax = _bounds(new)
    jcfg = J.RemodeConfig(num_planes=96, propagate_depth=True)
    want = [np.asarray(x) for x in jprop.propagate_depth(
        jax_run["pre_state"], jnp.asarray(_Tcw(new)), JScene.create(dmin, dmax, jcfg),
        JCam.create(**CAM), jcfg)]
    pcfg = P.RemodeConfig(num_planes=96, propagate_depth=True)
    got = [x.numpy() for x in pprop.propagate_depth(
        P.state_from_numpy(jax_run["pre"], device="cpu"), torch.tensor(_Tcw(new)),
        PScene.create(dmin, dmax, pcfg, device="cpu"),
        PCam.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], device="cpu"), pcfg)]
    valid_got, valid_want = got[4], want[4]
    assert valid_want.mean() > 0.15
    assert np.mean(valid_got == valid_want) >= 0.999
    both = valid_got & valid_want
    for i, name in enumerate(("mu", "sigma_sq")):
        assert _rel(got[i], want[i])[both].max() <= 1e-4, name
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_updates_after_propagated_switch(frames, jax_run):
    """(c) Eight updates after the switch, from the same carried state:
    conv states agree on >= 0.999 of pixels, and mu of the seeds both keep
    updating within 1e-3 of the depth range at the 0.99 quantile (the bound
    of tests/test_torch_depthmap.py; no seed converges in eight updates on
    this scene)."""
    eng = _engine(P, device="cpu")
    eng.restore(P.state_from_numpy(jax_run["pre"], device="cpu"))
    new = frames[SWITCH]
    eng.set_reference_image(new.image, _Tcw(new), *_bounds(new))
    for fr in frames[SWITCH + 1:SWITCH + 9]:
        eng.update(fr.image, _Tcw(fr))
    got, want = P.state_to_numpy(eng.state), jax_run["after"]
    assert np.mean(got["conv"] == want["conv"]) >= 0.999
    dmin, dmax = _bounds(new)
    upd = int(P.ConvergenceState.UPDATE)
    both = (got["conv"] == upd) & (want["conv"] == upd)
    assert both.mean() > 0.1, both.mean()
    d_mu = np.abs(got["mu"] - want["mu"])[both] / (dmax - dmin)
    assert np.quantile(d_mu, 0.99) <= 1e-3, np.quantile(d_mu, 0.99)


@pytest.mark.parametrize("chunk", [1, 7])
def test_batched_reseed_equals_per_plane_loop(frames, jax_run, monkeypatch, chunk):
    """The reseed warps its planes ``WARP_CHUNK`` at a time; one plane a
    warp (the per-plane loop) and a chunk that leaves a ragged last batch
    give the same five outputs bit for bit."""
    from rpg_open_remode_tpu_torch.ops import propagate as pprop

    new = frames[SWITCH]
    pcfg = P.RemodeConfig(num_planes=96, propagate_depth=True)
    args = (P.state_from_numpy(jax_run["pre"], device="cpu"), torch.tensor(_Tcw(new)),
            PScene.create(*_bounds(new), pcfg, device="cpu"),
            PCam.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], device="cpu"), pcfg)
    batched = pprop.propagate_depth(*args)
    assert float(batched[4].float().mean()) > 0.15
    monkeypatch.setattr(pprop, "WARP_CHUNK", chunk)
    for got, want in zip(pprop.propagate_depth(*args), batched):
        assert torch.equal(got, want)
