"""K-means clustering application: batch trainer, serving model and REST
endpoints (counterpart of ``oryx_tpu/app/kmeans``; the speed-layer
centroid drift and the HTML console are not ported yet).
"""
