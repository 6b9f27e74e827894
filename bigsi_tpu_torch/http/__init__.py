from bigsi_tpu_torch.http.server import make_server, serve

__all__ = ["make_server", "serve"]
