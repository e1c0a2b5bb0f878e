"""Query plane and the frequency-cap statistics service of the port."""
