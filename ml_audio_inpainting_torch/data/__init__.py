"""Datasets of the port (the synthetic corpus of the serving benchmark)."""
