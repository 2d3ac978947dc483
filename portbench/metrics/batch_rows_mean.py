"""/recommend answers per scan launch in the window, from the program's
scan launch counts: the batcher's rows per batch."""

UNIT = "rows"


def read(art):
    if art.get("kind") != "als_serve" or not art.get("scan_launches"):
        return None
    return art["answers"] / art["scan_launches"]
