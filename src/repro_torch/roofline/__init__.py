"""Three-term roofline of a step on H100s (``analysis``) from the counts
of one traced step (``count``)."""
