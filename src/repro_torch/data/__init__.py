"""Synthetic corpora and token pipelines (numpy copies of
``repro/data/synthetic.py`` and ``repro/data/tokens.py``)."""
