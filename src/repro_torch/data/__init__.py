"""Dense and CSR corpus files and the host data pipelines of the port."""
