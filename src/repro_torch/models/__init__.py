"""Model definitions of the port (dense decoder LM)."""
