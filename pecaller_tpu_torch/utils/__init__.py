"""Host utilities of the port: hugepage numpy allocation, logging."""
