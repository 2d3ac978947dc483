"""Common substrate: config, RNG, text wire formats, IO, PMML, tracing.

Counterpart of ``oryx_tpu/common``: the modules here are copies of its
JAX-free modules.
"""
