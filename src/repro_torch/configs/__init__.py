"""Model configurations of the ported paths (port of ``repro/configs``)."""
