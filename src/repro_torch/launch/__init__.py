"""Entry points: greedy-decode serving."""
