"""Model configurations: the ten assigned architectures (full and smoke)."""
