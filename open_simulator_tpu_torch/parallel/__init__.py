"""Capacity planning over many scenarios of one encoding (sweep.py)."""
