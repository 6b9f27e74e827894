from bigsi_tpu_torch.graph.bigsi import BIGSI

__all__ = ["BIGSI"]
