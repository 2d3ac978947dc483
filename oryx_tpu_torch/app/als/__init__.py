"""ALS collaborative-filtering application: batch trainer, speed-layer
fold-in, serving model with LSH pruning, REST endpoints and HTML console
(counterpart of ``oryx_tpu/app/als``).
"""
