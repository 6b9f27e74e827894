"""HTTP API of the port: bigsi_tpu's routes and request handler, with
searches answered by :class:`bigsi_tpu_torch.BIGSI`."""

from __future__ import annotations

import logging

from bigsi_tpu.http import server as host_server
from bigsi_tpu_torch.graph import BIGSI

logger = logging.getLogger(__name__)


class BigsiHTTPServer(host_server.BigsiHTTPServer):
    def __init__(self, addr, config, device=None):
        self.device = device
        super().__init__(addr, config)

    @property
    def bigsi(self) -> BIGSI:
        with self._lock:
            if self._bigsi is None:
                self._bigsi = BIGSI(self.config, device=self.device)
            return self._bigsi


def make_server(config, host="0.0.0.0", port=8000, device=None) -> BigsiHTTPServer:
    return BigsiHTTPServer((host, port), config, device)


def serve(config, host="0.0.0.0", port=8000, device=None) -> None:
    server = make_server(config, host, port, device)
    logger.info("bigsi-tpu-torch serving on %s:%d", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.invalidate()
        server.server_close()
