"""Data-parallel training across ranks (``dp.py``)."""
