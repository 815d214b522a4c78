"""The port's user scripts (counterparts of the repo's ``scripts/``)."""
