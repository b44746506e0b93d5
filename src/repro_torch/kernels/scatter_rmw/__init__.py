"""Row-table scatter-RMW: kernel wrapper, plain version, plan wrapper."""
