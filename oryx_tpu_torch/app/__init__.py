"""App tier (counterpart of ``oryx_tpu/app``): schema/PMML glue and the
ALS serving application.
"""
