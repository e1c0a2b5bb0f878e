"""Neural-net layers of the LM serving path (port of ``repro/layers``)."""
