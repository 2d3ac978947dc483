"""Random decision forest application: forest training on the card,
portable forest inference, leaf-stat speed updates, prediction serving
(counterpart of ``oryx_tpu/app/rdf``; the HTML console is not ported
yet).
"""
