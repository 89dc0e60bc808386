"""Durable-commit helpers of the port's on-disk artifacts (the commit
protocol of ``repro/checkpoint/manager.py``; the checkpoint manager itself
is not ported yet)."""
