"""Framework-level helpers of the port."""
