"""Default configurations (reference: ``bigsi/constants.py``)."""

DEFAULT_PARAMETERS = {"k": 31, "m": 25 * 10 ** 6, "h": 3}

DEFAULT_STORAGE_CONFIG = {"filename": "bigsi-tpu-index"}

DEFAULT_CONFIG = {
    "storage-engine": "bigsi-tpu",
    "storage-config": DEFAULT_STORAGE_CONFIG,
    **DEFAULT_PARAMETERS,
}

DEFAULT_MEMORY_CONFIG = {
    "storage-engine": "memory",
    "storage-config": {"filename": "default"},
    **DEFAULT_PARAMETERS,
}

DEFAULT_NPROC = 4
