"""The port of the reference's ``examples/``: quickstart, out-of-domain
transfer, serving and the bi-encoder's train -> encode -> prune -> serve.

Each runs as ``python -m repro_torch.examples.<name>`` with the reference
script's sizes, seeds and printed lines, on the card unless ``--device cpu``
is given, and keeps its body in a function a caller can run at another size.
``make_dataset`` keys its generators on ``hash(str)``, so two runs print the
same numbers only under one ``PYTHONHASHSEED``.
"""
