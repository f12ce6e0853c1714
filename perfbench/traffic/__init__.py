"""Traffic drivers, one a kind, and the data they make from the seed."""
