"""repro_torch.config — the process-global settings facade (twin of
``repro.config``).

Environment variables bootstrap the settings (CI lanes and shell
one-liners flip them without code); a program embedding the port sets
them through one entry point instead of mutating ``os.environ``::

    import repro_torch
    repro_torch.configure(device="gpu-h100", tune_cache="/tmp/plans.json",
                          obs_trace="run.jsonl")
    ...
    repro_torch.configure(obs=False)       # selective teardown
    repro_torch.config.reset()             # back to env/default bootstrap

Precedence (highest wins):

1. values set through :func:`configure` (process-local overrides),
2. the corresponding environment variable,
3. the built-in default.

The port's variables are its own (``REPRO_TORCH_*``), so a process that
imports both packages never switches on the other package's tracer or
plan cache.  The consumers (``tune.search.cache_path``/``cache_only``,
``tune.device.detect_device``) re-read the settings on every call;
``obs``/``obs_trace`` are applied at configure time (the tracer is
(re)installed), as the import-time bootstrap of :mod:`repro_torch.obs`
applies the variables.

This module imports only the standard library, so ``import repro_torch``
stays light and the tune/obs consumers import it without cycles.
"""
from __future__ import annotations

import os
from typing import Any, Optional

__all__ = ["KNOWN_SETTINGS", "configure", "get", "get_bool", "reset"]

#: setting name -> (environment variable, default)
KNOWN_SETTINGS: dict[str, tuple[str, Optional[str]]] = {
    "device": ("REPRO_TORCH_TUNE_DEVICE", None),
    "tune_cache": ("REPRO_TORCH_TUNE_CACHE", None),
    "tune_cache_only": ("REPRO_TORCH_TUNE_CACHE_ONLY", None),
    "obs": ("REPRO_TORCH_OBS", None),
    "obs_trace": ("REPRO_TORCH_OBS_TRACE", None),
}

_UNSET = object()

#: process-local overrides (highest precedence)
_overrides: dict[str, Any] = {}


def configure(**settings) -> None:
    """Set process-global settings (see the module docstring).

    Unknown names raise ``KeyError`` listing the valid ones.  ``None``
    clears an override, restoring env/default precedence.  Booleans are
    accepted for the flag-like settings (``tune_cache_only``, ``obs``).
    """
    unknown = set(settings) - set(KNOWN_SETTINGS)
    if unknown:
        raise KeyError(
            f"unknown setting(s) {sorted(unknown)}; "
            f"known: {sorted(KNOWN_SETTINGS)}")
    if settings.get("device") is not None:
        # a bad device key fails here, not at the first dispatch
        from repro_torch.tune.device import DEVICE_TABLE
        dev = settings["device"]
        if dev not in DEVICE_TABLE:
            raise KeyError(f"device={dev!r} not in device table "
                           f"{sorted(DEVICE_TABLE)}")
    for name, value in settings.items():
        if value is None:
            _overrides.pop(name, None)
        else:
            _overrides[name] = value
    if "obs" in settings or "obs_trace" in settings:
        _apply_obs()


def get(name: str, default: Any = _UNSET) -> Any:
    """Resolved value of ``name``: override > env var > default."""
    if name not in KNOWN_SETTINGS:
        raise KeyError(f"unknown setting {name!r}; "
                       f"known: {sorted(KNOWN_SETTINGS)}")
    if name in _overrides:
        return _overrides[name]
    env_var, builtin = KNOWN_SETTINGS[name]
    env = os.environ.get(env_var)
    if env is not None:
        return env
    return builtin if default is _UNSET else default


def get_bool(name: str) -> bool:
    """Flag-style resolution: False for unset/""/"0"/False, else True."""
    value = get(name)
    if value is None or value is False:
        return False
    if value is True:
        return True
    return str(value) not in ("", "0")


def reset() -> None:
    """Drop every override and re-bootstrap obs from the environment."""
    had_obs = "obs" in _overrides or "obs_trace" in _overrides
    _overrides.clear()
    if had_obs:
        _apply_obs()


def _apply_obs() -> None:
    """(Re)install the tracer from the resolved obs/obs_trace settings."""
    from repro_torch import obs
    trace_path = get("obs_trace")
    if trace_path:
        obs.configure(enabled=True, trace_path=str(trace_path))
    elif get_bool("obs"):
        obs.configure(enabled=True)
    else:
        obs.configure(enabled=False)
