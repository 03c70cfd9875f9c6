"""Model code of the port (recsys towers on the packed embedding table)."""
