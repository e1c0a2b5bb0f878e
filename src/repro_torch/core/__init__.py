"""Sampling core of the port: hashing, segments, chunked samplers, estimators."""
