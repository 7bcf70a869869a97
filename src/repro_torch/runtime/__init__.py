"""Step-level fault tolerance of the port."""
