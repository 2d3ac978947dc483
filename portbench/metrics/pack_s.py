"""Mean seconds of the host's neighbour packing per generation, from the
program's ``ops.als.last_phase_seconds["pack"]`` of each window generation."""

UNIT = "s"


def read(art):
    gens = art.get("generations") if art.get("kind") == "als_train" else None
    if not gens:
        return None
    return sum(g["pack"] for g in gens) / len(gens)
