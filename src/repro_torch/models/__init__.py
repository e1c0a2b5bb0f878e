"""Models of the LM serving path (port of ``repro/models``)."""
