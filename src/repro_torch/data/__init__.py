"""Synthetic corpora, token pipelines and recsys batches (numpy copies of
``repro/data/synthetic.py``, ``repro/data/tokens.py`` and
``repro/data/recsys.py``)."""
