"""The window's /recommend model FLOPs (roofline.recommend_flops per full
answer) over the window's seconds and the card's peak for the plane's
dtype (float32: roofline.PEAK_OPS)."""

from portbench import roofline

UNIT = "%"


def read(art):
    if art.get("kind") != "als_serve" or not art.get("answers_full"):
        return None
    flops = art["answers_full"] * roofline.recommend_flops(art["n_items"], art["features"])
    return 100.0 * flops / (art["window_s"] * roofline.PEAK_OPS[art["score_dtype"]])
