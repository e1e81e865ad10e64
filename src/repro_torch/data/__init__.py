"""Dense corpus files and the host data pipeline of the port."""
