from bigsi_tpu_torch.index.device_engine import DeviceEngine, load_words

__all__ = ["DeviceEngine", "load_words"]
