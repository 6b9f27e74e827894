from bigsi_tpu_torch.storage.kv import TypedKV
from bigsi_tpu_torch.storage.index_store import IndexStore, MemoryStore, get_storage

__all__ = ["TypedKV", "IndexStore", "MemoryStore", "get_storage"]
