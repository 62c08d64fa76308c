"""Ensembles of hybrid models (`ensemble.py`)."""
