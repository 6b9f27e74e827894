"""``merge`` command (reference: ``bigsi/cmds/merge.py``)."""


def merge(index1, index2) -> dict:
    index1.merge(index2)
    return {"result": "success"}
