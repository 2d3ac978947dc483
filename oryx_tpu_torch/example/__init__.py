"""Word-count example app: the bare SPI without the ML tier.

Rebuild of app/example (SURVEY.md §2.11): counts, for each word, the
number of distinct other words it co-occurs with on input lines; serves
the counts over /distinct and accepts new lines over /add.

Port note: a copy of ``oryx_tpu/example/__init__.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``.
"""
