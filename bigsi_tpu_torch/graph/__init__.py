from bigsi_tpu_torch.graph.bigsi import BIGSI, BigsiQueryResult

__all__ = ["BIGSI", "BigsiQueryResult"]
