"""Mean self time of the program's ``serving.request`` spans in the window:
each span's length less its queue-wait, assemble and scan children, the
front and dispatch. Read from the program's span ring at sample rate 1."""

UNIT = "ms"


def read(art):
    spans = art.get("spans") if art.get("kind") == "als_serve" else None
    if not spans:
        return None
    children: dict[str, float] = {}
    for s in spans:
        if s["parent"] is not None and s["name"] != "serving.request":
            children[s["parent"]] = children.get(s["parent"], 0.0) + s["dur"]
    own = [s["dur"] - children.get(s["span"], 0.0) for s in spans
           if s["name"] == "serving.request"]
    return 1e3 * sum(own) / len(own) if own else None
