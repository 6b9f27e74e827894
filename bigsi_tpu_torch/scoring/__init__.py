from bigsi_tpu_torch.scoring.score import Scorer

__all__ = ["Scorer"]
