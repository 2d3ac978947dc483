"""K-means clustering application: batch trainer, speed-layer centroid
drift, serving model, REST endpoints and HTML console (counterpart of
``oryx_tpu/app/kmeans``).
"""
