"""Config loading + validation.

Reference: YAML file path from CLI arg or ``BIGSI_CONFIG`` env, else
defaults (``bigsi/__main__.py:86-94``).  Schema is a superset of the
reference's: ``k``, ``m``, ``h``, ``nproc``, ``storage-engine``,
``storage-config``, ``max_build_mem_bytes`` plus ``engine`` (unset: the
CUDA engine; "numpy": the host engine) and the layout keys.  ``mesh`` is
validated as bigsi_tpu validates it, though the port serves no mesh.
Unlike the reference (which KeyErrors at point of use), configs are
validated up front.
"""

from __future__ import annotations

import os

import yaml

from bigsi_tpu_torch.constants import DEFAULT_CONFIG

from bigsi_tpu_torch.hashing.scheme import (  # single source of truth
    KNOWN_TILE_ROWS,
    LAYOUTS as KNOWN_LAYOUTS,
    SLOT_SCHEMES,
)

REQUIRED_KEYS = ("k", "m", "h")
KNOWN_ENGINES = ("numpy",)  # besides unset, the CUDA engine


def get_config_from_file(config_file: str | None) -> dict:
    if config_file is None:
        if os.environ.get("BIGSI_CONFIG"):
            config_file = os.environ.get("BIGSI_CONFIG")
        else:
            return dict(DEFAULT_CONFIG)
    with open(config_file, "r") as infile:
        config = yaml.safe_load(infile)
    return validate_config(config)


def validate_config(config: dict) -> dict:
    for key in REQUIRED_KEYS:
        if key not in config:
            raise ValueError("config missing required key %r" % key)
        if not isinstance(config[key], int) or config[key] <= 0:
            raise ValueError("config key %r must be a positive integer" % key)
    engine = config.get("engine", "numpy")
    if engine not in KNOWN_ENGINES:
        raise ValueError(
            "unknown engine %r (expected one of %s)" % (engine, list(KNOWN_ENGINES))
        )
    layout = config.get("layout", "classic")
    if layout not in KNOWN_LAYOUTS:
        raise ValueError(
            "unknown layout %r (expected one of %s)" % (layout, list(KNOWN_LAYOUTS))
        )
    tile_rows = config.get("tile-rows", 32)
    if tile_rows not in KNOWN_TILE_ROWS:
        raise ValueError(
            "config key 'tile-rows' must be one of %s, got %r"
            % (list(KNOWN_TILE_ROWS), tile_rows)
        )
    if layout == "classic" and "tile-rows" in config and tile_rows != 32:
        raise ValueError("'tile-rows' only applies to blocked/minimizer layouts")
    mesh = config.get("mesh")
    if mesh is not None:
        if (
            not isinstance(mesh, (list, tuple))
            or not 1 <= len(mesh) <= 4
            or not all(isinstance(a, int) and a >= 1 for a in mesh)
        ):
            raise ValueError(
                "config key 'mesh' must be a list of 1-4 positive axis sizes "
                "(d, k, s[, r row-shards]), got %r" % (mesh,)
            )
        if len(mesh) > 3 and mesh[3] > 1 and layout not in (
            "blocked", "minimizer"
        ):
            raise ValueError(
                "row sharding (mesh[3] > 1) needs a tile layout "
                "(blocked/minimizer)"
            )
    slot_scheme = config.get("slot-scheme")
    if slot_scheme is not None:
        if layout != "minimizer":
            raise ValueError(
                "'slot-scheme' only applies to the minimizer layout"
            )
        if slot_scheme not in SLOT_SCHEMES:
            raise ValueError(
                "'slot-scheme' must be one of %s, got %r"
                % (list(SLOT_SCHEMES), slot_scheme)
            )
        if slot_scheme == 2 and config.get("h", 0) > 5:
            raise ValueError(
                "slot scheme v2 derives h slots from one 32-bit hash and "
                "supports h <= 5; got h=%r" % (config.get("h"),)
            )
        if slot_scheme == 3 and config.get("h", 0) > 10:
            raise ValueError(
                "slot scheme v3 derives h slots from one 64-bit hash and "
                "supports h <= 10; got h=%r" % (config.get("h"),)
            )
    run_len = config.get("run-len")
    if run_len is not None:
        if layout != "minimizer":
            raise ValueError("'run-len' only applies to the minimizer layout")
        if not isinstance(run_len, int) or run_len < 1:
            raise ValueError(
                "'run-len' must be a positive integer, got %r" % (run_len,)
            )
    window = config.get("minimizer-window")
    if window is not None:
        if layout != "minimizer":
            raise ValueError(
                "'minimizer-window' only applies to the minimizer layout"
            )
        k = config["k"]
        if not isinstance(window, int) or not 1 <= window <= k:
            raise ValueError(
                "'minimizer-window' must be an integer in [1, k], got %r"
                % (window,)
            )
        # s-mers must be effectively unique or popular minimizers crowd
        # tiles catastrophically (measured: s=9 drives FPR to 0.55+ —
        # hashing/scheme.py default_minimizer_s)
        if k - window + 1 < 13:
            raise ValueError(
                "'minimizer-window' %d leaves s-mers of %d bases; s must "
                "be >= 13 so minimizers stay effectively unique" % (
                    window, k - window + 1,
                )
            )
    screen = config.get("screen")
    if screen is not None:
        if screen is not True and screen != "minimizer":
            raise ValueError(
                "config key 'screen' must be 'minimizer', got %r" % (screen,)
            )
        if layout != "classic":
            raise ValueError(
                "a screened (verified) index keeps layout=classic - the "
                "minimizer structure is the SCREEN; got layout=%r" % layout
            )
        sm = config.get("screen-m", config["m"])
        if not isinstance(sm, int) or sm <= 0:
            raise ValueError("'screen-m' must be a positive integer")
        str_ = config.get("screen-tile-rows", 16)
        if str_ not in KNOWN_TILE_ROWS:
            raise ValueError(
                "'screen-tile-rows' must be one of %s, got %r"
                % (list(KNOWN_TILE_ROWS), str_)
            )
        sw = config.get("screen-window", 19)
        k = config["k"]
        if not isinstance(sw, int) or not 1 <= sw <= k or k - sw + 1 < 13:
            raise ValueError(
                "'screen-window' must be an integer in [1, k] leaving "
                "s-mers >= 13 bases, got %r" % (sw,)
            )
        if config.get("h", 0) > 10:
            raise ValueError(
                "screened indexes use slot scheme v3 (h <= 10); got h=%r"
                % (config.get("h"),)
            )
        srl = config.get("screen-run-len")
        if srl is not None and (not isinstance(srl, int) or srl < 1):
            # run_len=0 would silently dispatch GROUP_R instead of the
            # persisted shape ('or' fallbacks treat 0 as absent);
            # negative values only fail at the first query
            raise ValueError(
                "'screen-run-len' must be a positive integer, got %r"
                % (srl,)
            )
    else:
        for key in ("screen-m", "screen-tile-rows", "screen-window",
                    "screen-run-len", "verify-margin"):
            if key in config:
                raise ValueError(
                    "config key %r needs 'screen: minimizer'" % key
                )
    vm = config.get("verify-margin")
    if vm is not None and (not isinstance(vm, int) or vm < 0):
        raise ValueError(
            "'verify-margin' must be a non-negative integer, got %r" % (vm,)
        )
    if config["k"] > 31:
        raise ValueError("k must be <= 31 (2-bit uint64 packing)")
    return config


def parse_size(text) -> int:
    """Parse human-friendly sizes ("500MB", "4GiB", 1024) -> bytes.

    Replaces the reference's ``humanfriendly.parse_size``
    (``__main__.py:161-164``).
    """
    if isinstance(text, (int, float)):
        return int(text)
    s = str(text).strip().upper().replace(" ", "")
    units = {
        "B": 1,
        "KB": 10 ** 3, "MB": 10 ** 6, "GB": 10 ** 9, "TB": 10 ** 12,
        "KIB": 2 ** 10, "MIB": 2 ** 20, "GIB": 2 ** 30, "TIB": 2 ** 40,
        "K": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12,
    }
    for unit in sorted(units, key=len, reverse=True):
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * units[unit])
    return int(float(s))
