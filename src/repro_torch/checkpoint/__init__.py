"""Checkpoint files of the port (port of ``repro/checkpoint``)."""
