"""``delete`` command (reference: ``bigsi/cmds/delete.py``)."""


def delete(graph) -> dict:
    graph.delete()
    return {"result": "success"}
