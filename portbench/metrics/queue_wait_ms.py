"""Mean length of the program's ``serving.queue-wait`` spans in the window:
the batcher's wait from enqueue to dispatch."""

UNIT = "ms"


def read(art):
    spans = art.get("spans") if art.get("kind") == "als_serve" else None
    waits = [s["dur"] for s in spans or () if s["name"] == "serving.queue-wait"]
    return 1e3 * sum(waits) / len(waits) if waits else None
