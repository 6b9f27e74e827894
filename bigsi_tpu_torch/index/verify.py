"""Verified indexes, the build side: the screen's parameters.

A verified (screened) index keeps two structures: ``rows.bin``, the
canonical classic matrix, and ``screen.bin``, a minimizer-layout matrix
over the same samples that bounds hit counts from above; a query
screens candidates on the minimizer matrix and verifies them on the
classic one (bigsi_tpu's ``index/verify.py``).  The port builds such
indexes (``bloom``, ``build``: :func:`screen_params_from_config`) with
bigsi_tpu's exact files, and does not serve them yet: opening one in
:class:`bigsi_tpu_torch.BIGSI` raises ``NotImplementedError``.
"""

from __future__ import annotations

from bigsi_tpu_torch.hashing.scheme import (
    MINIMIZER,
    SLOT_SCHEME_V3,
    default_run_len,
)

# the screen's defaults: the minimizer/16 w = 19 cols config
DEFAULT_SCREEN_WINDOW = 19
DEFAULT_SCREEN_TILE_ROWS = 16


def screen_params_from_config(config: dict) -> dict | None:
    """Resolve the screen build parameters, or None when not verified.

    Enabled by ``screen: minimizer`` (the only screen layout).  Keys:
    ``screen-m`` (default m), ``screen-tile-rows`` (default 16),
    ``screen-window`` (default 19), ``screen-run-len`` (default w+1).
    """
    screen = config.get("screen")
    if screen is None:
        return None
    if screen is not True and screen != MINIMIZER:
        raise ValueError(
            "config key 'screen' must be 'minimizer', got %r" % (screen,)
        )
    window = config.get("screen-window", DEFAULT_SCREEN_WINDOW)
    return {
        "m": int(config.get("screen-m", config["m"])),
        "tile_rows": int(
            config.get("screen-tile-rows", DEFAULT_SCREEN_TILE_ROWS)
        ),
        "window": int(window),
        "slot_scheme": SLOT_SCHEME_V3,
        "run_len": int(config.get("screen-run-len", default_run_len(window))),
    }
