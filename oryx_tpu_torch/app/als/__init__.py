"""ALS collaborative-filtering application: serving model + REST
endpoints (counterpart of ``oryx_tpu/app/als``; the batch trainer and the
speed-layer fold-in are not ported yet).
"""
