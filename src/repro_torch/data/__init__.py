"""Synthetic corpora (numpy copy of ``repro/data/synthetic.py``)."""
