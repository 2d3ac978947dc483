"""Native components (counterpart of ``oryx_tpu/native``): only the
pure-Python paths of ``store.py`` are ported so far. The C++ feature
store, parser and HTTP front are not.
"""
