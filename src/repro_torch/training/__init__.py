"""Step builders of the port (the serving steps)."""
