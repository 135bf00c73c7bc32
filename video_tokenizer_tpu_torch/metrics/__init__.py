"""Training-time statistics of the port."""
