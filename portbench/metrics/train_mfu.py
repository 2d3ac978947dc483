"""The window's ALS model FLOPs (roofline.als_model_flops, per iteration
of every whole generation) over the window's seconds and the card's
float32 peak."""

from portbench import roofline

UNIT = "%"


def read(art):
    if art.get("kind") != "als_train" or not art.get("generations"):
        return None
    flops = art["model_flops_per_iteration"] * art["iterations"] * len(art["generations"])
    return 100.0 * flops / (art["window_s"] * roofline.PEAK_OPS["float32"])
