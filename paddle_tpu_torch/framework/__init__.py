"""Framework pieces of the port (typed errors)."""
