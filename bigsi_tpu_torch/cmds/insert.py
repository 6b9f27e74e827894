"""``insert`` command (reference: ``bigsi/cmds/insert.py``)."""

from bigsi_tpu_torch.cmds.build import load_bloomfilter


def insert(index, bloomfilter, sample) -> dict:
    index.insert(load_bloomfilter(bloomfilter), sample)
    return {"result": "success"}
