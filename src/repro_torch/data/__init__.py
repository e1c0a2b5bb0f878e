"""Synthetic data generators (numpy only), copies of ``repro/data``'s."""
