"""Checkpoint reading and writing, parameter conversion, devices, config, logging."""
