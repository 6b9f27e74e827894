"""The BIGSI facade on the CUDA engine.

:class:`bigsi_tpu.graph.bigsi.BIGSI` with the port's
:class:`~bigsi_tpu_torch.index.device_engine.DeviceEngine` plugged into
its engine seam: hashing, storage, metadata, scoring and the result
dicts are bigsi_tpu's own jax-free code.  The config's ``engine``:

* absent: the CUDA engine (on ``device``, CUDA unless given);
* ``numpy``: bigsi_tpu's host engine;
* anything else is refused: the JAX engines are not part of the port.

Screened (verified) indexes are not ported yet and raise.
"""

from __future__ import annotations

import functools

from bigsi_tpu.constants import DEFAULT_CONFIG
from bigsi_tpu.graph import bigsi as host_facade
from bigsi_tpu.index.host_engine import HostEngine
from bigsi_tpu.utils.profiling import phase
from bigsi_tpu_torch.index.device_engine import DeviceEngine


def engine_factory_for(config: dict, device=None):
    engine = config.get("engine")
    if engine == "numpy":
        return HostEngine
    if engine is not None:
        raise ValueError(
            "engine %r is not part of bigsi_tpu_torch: leave 'engine' unset "
            "for the CUDA engine, or set it to 'numpy'" % engine
        )
    return functools.partial(DeviceEngine, device=device)


class BIGSI(host_facade.BIGSI):
    # the facade would stage the JAX DeviceVerifier for screened indexes,
    # which this class refuses
    verifier = None

    def __init__(self, config=None, engine_factory=None, device=None):
        if config is None:
            config = DEFAULT_CONFIG
        if engine_factory is None:
            engine_factory = engine_factory_for(config, device)
        super().__init__(config, engine_factory=engine_factory)
        if self.screen is not None:
            raise NotImplementedError(
                "screened (verified) indexes are not served by "
                "bigsi_tpu_torch yet"
            )

    def _batch_results(self, per_query, counts, threshold, score_info=None):
        # timed beside the facade's "search.batch_counts", so one
        # search_batch splits into k-mer prep, engine counts and results
        with phase("search.batch_results"):
            return super()._batch_results(per_query, counts, threshold, score_info)
