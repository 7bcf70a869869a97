"""Token data pipeline of the port."""
