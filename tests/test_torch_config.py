"""The port's config dataclasses carry the JAX package's defaults."""

import dataclasses

import pytest

import send_slam_tpu.config as jcfg
import send_slam_tpu_torch.config as tcfg

NAMES = ["OrbConfig", "CameraConfig", "MapConfig", "TrackingConfig",
         "ServerConfig", "EngineConfig"]


@pytest.mark.parametrize("name", NAMES)
def test_field_defaults_match(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert list(jf) == list(tf)
    for k in jf:
        if dataclasses.is_dataclass(jf[k]):
            assert dataclasses.asdict(jf[k]) == dataclasses.asdict(tf[k]), k
        else:
            assert jf[k] == tf[k], k


@pytest.mark.parametrize("n_features,n_levels", [(1250, 8), (512, 4),
                                                 (300, 3)])
def test_per_level_budgets_match(n_features, n_levels):
    kw = dict(n_features=n_features, n_levels=n_levels)
    assert jcfg.OrbConfig(**kw).per_level_features \
        == tcfg.OrbConfig(**kw).per_level_features
