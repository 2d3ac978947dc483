"""Random decision forest application: forest training on the card,
portable forest inference, leaf-stat speed updates, prediction serving
and the HTML console (counterpart of ``oryx_tpu/app/rdf``).
"""
