"""Row-table gather: kernel wrapper, plain version, plan wrapper."""
