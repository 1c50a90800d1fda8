"""Drivers of the two kinds of run: ``train`` and ``infer``."""
