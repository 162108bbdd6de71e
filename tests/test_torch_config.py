"""The port's settings facade (``repro_torch.config``) against the
reference's (``repro.config``): override > env > default precedence, the
consumers that re-read it, and the two packages' settings kept apart.

Twins of ``tests/test_config.py`` with the port's ``REPRO_TORCH_*``
variables and device table; the same steps run through both facades
where they have a counterpart, and must resolve alike.
"""
import os

import pytest

import repro
import repro_torch
from repro import config as RC
from repro_torch import config


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for facade in (config, RC):
        for env_var, _ in facade.KNOWN_SETTINGS.values():
            monkeypatch.delenv(env_var, raising=False)
        facade.reset()
    yield
    config.reset()
    RC.reset()


def _env(facade, name):
    return facade.KNOWN_SETTINGS[name][0]


def test_facade_is_the_top_level_surface():
    assert repro_torch.configure is config.configure
    assert repro_torch.config is config
    assert set(config.KNOWN_SETTINGS) == set(RC.KNOWN_SETTINGS)
    assert all(env.startswith("REPRO_TORCH_")
               for env, _ in config.KNOWN_SETTINGS.values())


@pytest.mark.parametrize("facade,configure", [(config, repro_torch.configure),
                                              (RC, repro.configure)])
def test_default_then_env_then_override_precedence(monkeypatch, facade,
                                                   configure):
    var = _env(facade, "tune_cache")
    assert facade.get("tune_cache") is None            # built-in default
    monkeypatch.setenv(var, "/env/plans.json")
    assert facade.get("tune_cache") == "/env/plans.json"
    configure(tune_cache="/override/plans.json")       # facade wins
    assert facade.get("tune_cache") == "/override/plans.json"
    configure(tune_cache=None)                         # clear → env again
    assert facade.get("tune_cache") == "/env/plans.json"
    monkeypatch.delenv(var)
    assert facade.get("tune_cache") is None


def test_unknown_setting_fails_loudly():
    for configure, facade in ((repro_torch.configure, config),
                              (repro.configure, RC)):
        with pytest.raises(KeyError):
            configure(tune_cash="/tmp/x")
        with pytest.raises(KeyError):
            facade.get("tune_cash")


def test_get_bool_flag_semantics(monkeypatch):
    seen = {}
    for facade, configure in ((config, repro_torch.configure),
                              (RC, repro.configure)):
        var = _env(facade, "tune_cache_only")
        got = [facade.get_bool("tune_cache_only")]          # unset
        for value in ("", "0", "1"):
            monkeypatch.setenv(var, value)
            got.append(facade.get_bool("tune_cache_only"))
        configure(tune_cache_only=False)                 # override beats env
        got.append(facade.get_bool("tune_cache_only"))
        configure(tune_cache_only=True)
        got.append(facade.get_bool("tune_cache_only"))
        seen[facade.__name__] = got
    assert seen["repro_torch.config"] == [False, False, False, True, False,
                                          True]
    assert seen["repro_torch.config"] == seen["repro.config"]


def test_reset_restores_env_bootstrap(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_DEVICE", "gpu-a100")
    repro_torch.configure(device="gpu-h100")
    assert config.get("device") == "gpu-h100"
    config.reset()
    assert config.get("device") == "gpu-a100"


def test_device_override_validated_eagerly_and_consumed():
    with pytest.raises(KeyError):
        repro_torch.configure(device="gpu-v99")        # typo fails NOW
    with pytest.raises(KeyError):
        repro_torch.configure(device="tpu-v6e")        # the other table's
    from repro_torch.tune.device import detect_device
    repro_torch.configure(device="gpu-h100")
    assert detect_device().kind == "gpu-h100"
    repro_torch.configure(device="gpu-a100")           # re-read per call
    assert detect_device().kind == "gpu-a100"
    repro_torch.configure(device=None)
    assert detect_device("cpu").kind == "cpu"          # back to detection


def test_tune_cache_consumers_read_facade(tmp_path, monkeypatch):
    from repro_torch.tune import search
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "env.json"))
    assert search.cache_path() == str(tmp_path / "env.json")
    repro_torch.configure(tune_cache=str(tmp_path / "facade.json"))
    assert search.cache_path() == str(tmp_path / "facade.json")
    assert search.default_cache().path == str(tmp_path / "facade.json")
    assert search.cache_only() is False
    repro_torch.configure(tune_cache_only=True)
    assert search.cache_only() is True


def test_obs_configure_is_eager(tmp_path):
    from repro_torch import obs
    was_enabled = obs.is_enabled()
    try:
        repro_torch.configure(obs=True)
        assert obs.is_enabled()
        repro_torch.configure(obs=False)
        assert not obs.is_enabled()
        trace = tmp_path / "trace.jsonl"
        repro_torch.configure(obs_trace=str(trace))
        assert obs.is_enabled()
        obs.event("cfg.test", "serve", ok=1)
        repro_torch.configure(obs_trace=None, obs=False)   # close it
        assert not obs.is_enabled()
        assert trace.exists() and "cfg.test" in trace.read_text()
    finally:
        config.reset()
        obs.configure(enabled=was_enabled)


def test_env_bootstrap_untouched_by_facade(monkeypatch):
    # configure() never writes os.environ: child processes inherit the
    # shell's bootstrap, not the overrides
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "/env/plans.json")
    repro_torch.configure(tune_cache="/override.json")
    assert os.environ["REPRO_TORCH_TUNE_CACHE"] == "/env/plans.json"


def test_packages_keep_their_settings_apart(monkeypatch, tmp_path):
    """The reference's variables and overrides never reach the port, nor
    the port's the reference: a process importing both switches on one
    package's tracer or cache only."""
    from repro import obs as RO
    from repro_torch import obs
    from repro_torch.tune import search
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/ref/plans.json")
    repro.configure(tune_cache_only=True, obs=True)
    try:
        assert config.get("tune_cache") is None
        assert not config.get_bool("tune_cache_only")
        assert search.cache_path().endswith(
            os.path.join("repro-torch-tune", "plans.json"))
        assert RO.is_enabled() and not obs.is_enabled()
        repro.configure(obs=False)
        repro_torch.configure(tune_cache=str(tmp_path / "p.json"), obs=True)
        assert RC.get("tune_cache") == "/ref/plans.json"
        assert obs.is_enabled() and not RO.is_enabled()
    finally:
        repro_torch.configure(obs=False)
        RC.reset()
