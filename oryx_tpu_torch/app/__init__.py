"""App tier (counterpart of ``oryx_tpu/app``): schema/PMML glue and the
ALS, k-means and random-decision-forest applications.
"""
