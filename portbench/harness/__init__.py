"""The general parts of the benchmark: what every cell shares."""
