"""Model families, a file each, found by a configuration's ``family``."""
