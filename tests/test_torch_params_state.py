"""Port config and state vs the JAX package: Params and CZMGeometry equal
field for field, init_state equal, and an adaptive-state npz written by
either package loads in the other (same keys, same values; the port's state
also carries the last plane, ``plane``, which a JAX file lacks and loads as
the zero plane of a fresh state)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu.params as jparams
import patchworkpp_tpu.state as jstate
import patchworkpp_tpu_torch.params as tparams
import patchworkpp_tpu_torch.state as tstate

CZM_VARIANTS = [
    {},
    {"num_rings_each_zone": (3, 4, 4, 4), "num_sectors_each_zone": (16, 32, 64, 64)},
    {"min_range": 1.5, "max_range": 60.0, "num_zones": 4},
]


def test_params_fields_and_defaults_match():
    jf = {f.name: f for f in dataclasses.fields(jparams.Params)}
    tf = {f.name: f for f in dataclasses.fields(tparams.Params)}
    assert list(jf) == list(tf)
    for name in jf:
        assert jf[name].default == tf[name].default, name
        assert jf[name].type == tf[name].type, name
    assert jparams.Params() == jparams.Params(**dataclasses.asdict(tparams.Params()))


@pytest.mark.parametrize("kw", CZM_VARIANTS)
def test_geometry_matches(kw):
    jg = jparams.CZMGeometry.create(jparams.Params(**kw))
    tg = tparams.CZMGeometry.create(tparams.Params(**kw))
    for f in ("min_ranges", "ring_sizes", "sector_sizes", "zone_patch_offset",
              "num_patches", "num_concentric_rings", "spad"):
        assert getattr(jg, f) == getattr(tg, f), f
    for tab in ("patch_zone", "patch_concentric_ring", "patch_sector"):
        np.testing.assert_array_equal(getattr(jg, tab)(), getattr(tg, tab)(), tab)


def test_init_state_matches():
    p = dict(sensor_height=1.9, elevation_thr=(0.1, 0.2, 0.3, 0.4))
    js = jstate.init_state(jparams.Params(**p)).to_numpy()
    ts = tstate.init_state(tparams.Params(**p), device="cpu").to_numpy()
    assert tstate.BUF_CAP == jstate.BUF_CAP
    assert tstate.NUM_ADAPT_RINGS == jstate.NUM_ADAPT_RINGS
    assert list(ts) == [*js, "plane"]
    np.testing.assert_array_equal(ts["plane"], np.zeros(tstate.PLANE_WIDTH, np.float32))
    for k in js:
        assert js[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)


def _random_state(seed):
    rng = np.random.default_rng(seed)
    bufs, cnts = {}, {}
    for name in ("elev", "flat"):
        cnt = rng.integers(0, 1000, 4).astype(np.int32)
        buf = rng.normal(size=(4, jstate.BUF_CAP)).astype(np.float32)
        buf[np.arange(jstate.BUF_CAP)[None, :] >= cnt[:, None]] = 0.0
        bufs[name], cnts[name] = buf, cnt
    return {
        "sensor_height": np.float32(rng.uniform(1.5, 2.0)),
        "elevation_thr": rng.normal(size=4).astype(np.float32),
        "flatness_thr": rng.uniform(size=4).astype(np.float32),
        "elev_buf": bufs["elev"],
        "elev_cnt": cnts["elev"],
        "flat_buf": bufs["flat"],
        "flat_cnt": cnts["flat"],
    }


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_file_crosses_packages(tmp_path, direction):
    d = _random_state(7)
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_torch":
        jstate.AdaptiveState.from_numpy(d).save(path)
        back = tstate.AdaptiveState.load(path, device="cpu").to_numpy()
        plane = back.pop("plane")
        np.testing.assert_array_equal(plane, np.zeros(tstate.PLANE_WIDTH, np.float32))
    else:
        tstate.from_numpy(d, device="cpu").save(path)
        back = jstate.AdaptiveState.load(path).to_numpy()
    assert sorted(back) == sorted(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
        assert back[k].dtype == np.asarray(d[k]).dtype, k


def test_from_numpy_rezeroes_tails():
    d = _random_state(3)
    d["elev_buf"] = d["elev_buf"] + 1.0  # dirty past the counts
    st = tstate.from_numpy(d, device="cpu").to_numpy()
    cnt = d["elev_cnt"]
    tail = np.arange(tstate.BUF_CAP)[None, :] >= cnt[:, None]
    assert (st["elev_buf"][tail] == 0).all()
    np.testing.assert_array_equal(st["elev_buf"][~tail], d["elev_buf"][~tail])


@pytest.mark.parametrize("ctor", ["init_state", "from_numpy", "load"])
def test_state_constructors_default_to_cuda_and_refuse_without_it(tmp_path, monkeypatch, ctor):
    """init_state, from_numpy and AdaptiveState.load build on CUDA unless
    given a device, as every other entry point does; without a card they
    raise and name the way out, instead of building on the CPU."""
    path = str(tmp_path / "state.npz")
    tstate.init_state(tparams.Params(), device="cpu").save(path)
    calls = {
        "init_state": lambda: tstate.init_state(tparams.Params()),
        "from_numpy": lambda: tstate.from_numpy(_random_state(1)),
        "load": lambda: tstate.AdaptiveState.load(path),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[ctor]()
